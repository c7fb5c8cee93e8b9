// Spectral path-tracing megakernel: one thread owns one pixel's whole path,
// over all samples and all bounces, in registers. Its nearest hit is the
// dense sweep over a scene held in shared memory or, for large scenes, the
// Morton-leaf sweep (leaf_sweep.cuh) over a pack in device memory.
//
// Replaces the TPU kernel spectral_tpu/ops/pallas/render_kernel.py :1852
// _render_kernel in its dense form (use_bvh=False), launched by
// render_rays_pallas :2603, with its helpers _scatter_shade :1694, _lut :552
// and the draw order of n_uniforms :2314. It follows that kernel's
// semantics exactly (not the XLA wavefront path): the SPD is the
// sigmoid-polynomial evaluated at lambda directly, material flags come
// from the pack (is_lamb = clip(1 - metal - diel - emis)), emitters use
// power^2, the Sellmeier index comes from the hero wavelength only, and
// n_valid, bounce-limit exhaustion and the EPSILON offset sign follow
// :1824-1832 and :2284. This is also the original CUDA renderer's shape
// (rendering/rendering.cu:151-235).
//
// Uniform draws, per sample: 0-1 pixel jitter, 2 hero wavelength,
// 3+3b..5+3b bounce b (sphere z, sphere phi, reflect test), 3+3B and 4+3B
// the defocus disk. They come either from injected planes
// rand[spp, 5+3B, n] (the JAX kernel's layout, for tests) or from a
// counter-based hash of (chunk seed, global pixel index, sample, draw),
// which ops/cuda/render_kernel.py::hash_uniforms writes identically in
// PyTorch. The stream does not depend on the block size.
//
// Bound on an H100: FP32 arithmetic. Counted from this source, an fmaf as
// two flops: per live ray-step (one bounce of one sample) the sweep costs
// 51 flops per triangle (two 3-term dots, a subtract and a divide for the
// plane, three edge tests of 13) and the shading ~340 (seven
// sigmoid-polynomial SPD weights at 22 each, the sphere sample with its
// sin/cos, lambertian, metal, the Sellmeier index, Schlick and refraction,
// the state update); per sample another ~340 for the camera ray, the hero
// wavelengths, the 35 table lerps and the XYZ sum. So (51 T + 340) flops
// per live ray-step plus 340 per sample, against 12 bytes written per
// pixel (and 4 bytes read per injected draw): tens of kflop per byte.
// chip_smoke.py counts the live ray-steps of its run (the `steps` output)
// and divides by the card's 67 TFLOP/s for the bound.
// Design, right and simple first: the scene (tri pack [T <= 128, 17],
// material pack [M, 16], the five 95-sample curves; <= ~11 KB) is staged in
// shared memory once per block, and the sweep reads it as warp-uniform
// broadcasts; no atomics, each thread writes its own XYZ; no tiling of the
// sweep, no early out inside it, no sorting of rays. A path stops when it
// terminates (its state is frozen from then on in the JAX kernel too, and
// its draws are indexed, not consumed, so nothing else moves).
//
// The residual form (render_residuals_launch) replaces the same TPU kernel
// with save_residuals=True, launched by render_rays_pallas_residuals :2421
// (writes at :2029-2030, :2249-2258, :2286-2289). It is one template
// instantiation of the same source: kSaveResiduals adds the stores of the
// hero wavelength, n_valid, the final power and the per-bounce material
// residual, and nothing else. Its bound adds the 4 * (2 + 7 + bounces)
// residual bytes written per sample-ray to the forward's operations; the
// stores are per thread at [s][.][i], so a warp writes 128 contiguous bytes.
//
// The leaf form (kLeaves: render_leaves_launch and
// render_leaves_residuals_launch) replaces the same TPU kernel with
// use_bvh=True, whose nearest hit is _mxu_leaf_sweep :565, launched by the
// same two functions with a leaf pack (:2068-2088). Only the sweep
// differs: tri [NL * K, 18] and leaf [NL, 8] stay in device memory, and a
// ray tests the K triangles of each leaf it enters (leaf_sweep.cuh). Its
// bound is FP32 arithmetic as well, counted from its data: per live
// ray-step ~340 flops of shading plus ~25 per valid leaf's slab test, 51 per
// triangle of an entered leaf, and ~340 per sample; the `visits` output
// counts the leaves each pixel's rays entered.
//
// The camera ray, the curves, the shading and the XYZ tail are path.cuh's,
// shared with the sorted per-bounce kernels (wavefront_kernel.cu).
//
// Numerics: compiled with -fmad=false and without fast math. Every
// operation rounds once, in the JAX kernel's order, and a product fuses into
// a sum only through an explicit fmaf, placed where XLA's CPU backend
// contracts that kernel (ops/fp32.py). ops/cuda/render_kernel.py::
// render_rays_reference writes the same operations, so on the card the
// kernel and the plain version take the same discrete decisions (hit or
// miss, schlick > u, ratio * sin_t > 1).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hit.cuh"
#include "leaf_sweep.cuh"
#include "path.cuh"
#include "spectrum.cuh"

namespace {

using namespace spt;

constexpr int kBlock = 128;

// Path residuals of the fused backward (ops/cuda/grad_kernel.py), in the JAX
// kernel's sample-major, ray-minor layout: hero[s][i], n_valid[s][i] (after
// the bounce-limit rule), power[s][w][i] (final, frozen at termination),
// matres[s][b][i] = mat + 1 for a hit, -1 for a background miss, 0 for the
// bounces after the path ended.
struct Residuals {
  float* hero;
  float* n_valid;
  float* power;
  int* matres;
};

// The leaf pack of the kLeaves form.
struct Leaves {
  const float* leaf;
  int n_leaves;
  int leaf_size;
};

template <bool kSaveResiduals, bool kLeaves>
__global__ void __launch_bounds__(kBlock) render_kernel(
    const float* __restrict__ cam, uint32_t seed,
    const float* __restrict__ tri_pack, int n_tris, Leaves lv,
    const float* __restrict__ mat_pack, int n_mats,
    const float* __restrict__ tables, const float* __restrict__ px,
    const float* __restrict__ py, int n, int image_width, int spp, int bounces,
    const float* __restrict__ rand, float* __restrict__ xyz,
    int* __restrict__ steps, int* __restrict__ visits, Residuals res) {
  extern __shared__ float smem[];
  // the dense scene is staged; the leaf pack stays in device memory
  float* s_tri = smem;
  float* s_mat = s_tri + (kLeaves ? 0 : n_tris * kTriStride);
  float* s_tab = s_mat + n_mats * kMatStride;
  if constexpr (!kLeaves) stage(s_tri, tri_pack, n_tris * kTriStride);
  stage(s_mat, mat_pack, n_mats * kMatStride);
  stage(s_tab, tables, 5 * kSamples);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const Camera c = load_camera(cam);
  const float pxi = px[i], pyi = py[i];
  const int n_draws = 5 + 3 * bounces;
  const uint32_t key_pixel = pixel_key(seed, pxi, pyi, image_width);

  float accx = 0.0f, accy = 0.0f, accz = 0.0f;
  int live_steps = 0, leaf_visits = 0;

  for (int s = 0; s < spp; ++s) {
    const Draws u = sample_draws(rand, n, i, s, n_draws, key_pixel);
    Path st;
    start_path(st, camera_ray(c, pxi, pyi, u, bounces));

    // hero wavelengths (spectrum.cu:31-48) and their table cells
    const float hero = hero_wavelength(u(2));
    const size_t si = (size_t)s * n + i;
    if constexpr (kSaveResiduals) res.hero[si] = hero;
    Curves cv;
    hero_curves(hero, s_tab, cv);

    int b = 0;
    for (; b < bounces && st.alive; ++b) {
      ++live_steps;
      bool hit, front;
      float t;
      const float* tp;
      if constexpr (kLeaves) {
        const LeafHit h = nearest_hit_leaves(
            tri_pack, lv.leaf, lv.n_leaves, lv.leaf_size, st.r.ox, st.r.oy,
            st.r.oz, st.r.dx, st.r.dy, st.r.dz, leaf_visits);
        hit = h.hit, front = h.front, t = h.t;
        tp = tri_pack + (size_t)h.row * kLeafTriStride;
      } else {
        const NearestHit h = nearest_hit<kTriStride>(
            s_tri, n_tris, st.r.ox, st.r.oy, st.r.oz, st.r.dx, st.r.dy,
            st.r.dz);
        hit = h.hit, front = h.front, t = h.t;
        tp = s_tri + h.idx * kTriStride;
      }
      const int mres =
          shade(st, hit, front, t, tp, s_mat, cv, u(3 + 3 * b), u(4 + 3 * b),
                u(5 + 3 * b));
      if constexpr (kSaveResiduals)
        res.matres[((size_t)s * bounces + b) * n + i] = mres;
    }

    // bounce-limit exhaustion contributes nothing (rendering.cu:38-39)
    if (st.alive) st.n_valid = 0.0f;

    if constexpr (kSaveResiduals) {
      // the JAX kernel keeps an ended path frozen and records "none" for
      // each later bounce; the buffer is not zeroed beforehand
      for (; b < bounces; ++b) res.matres[((size_t)s * bounces + b) * n + i] = 0;
      res.n_valid[si] = st.n_valid;
#pragma unroll
      for (int w = 0; w < kW; ++w) res.power[((size_t)s * kW + w) * n + i] = st.power[w];
    }

    float sx_, sy_, sz_;
    path_xyz(st.power, st.n_valid, cv, s_tab, sx_, sy_, sz_);
    accx = accx + sx_;
    accy = accy + sy_;
    accz = accz + sz_;
  }

  xyz[3 * i] = accx;
  xyz[3 * i + 1] = accy;
  xyz[3 * i + 2] = accz;
  if (steps) steps[i] = live_steps;
  if constexpr (kLeaves) {
    if (visits) visits[i] = leaf_visits;
  }
}

template <bool kSaveResiduals, bool kLeaves>
int launch(const float* cam, uint32_t seed, const float* tri_pack, int n_tris,
           Leaves lv, const float* mat_pack, int n_mats, const float* tables,
           const float* px, const float* py, int n, int image_width, int spp,
           int bounces, const float* rand, float* xyz, int* steps, int* visits,
           Residuals res, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = sizeof(float) * ((kLeaves ? 0 : (size_t)n_tris * kTriStride) +
                                       (size_t)n_mats * kMatStride +
                                       5 * kSamples);
  const int grid = (n + kBlock - 1) / kBlock;
  render_kernel<kSaveResiduals, kLeaves>
      <<<grid, kBlock, smem, (cudaStream_t)stream>>>(
          cam, seed, tri_pack, n_tris, lv, mat_pack, n_mats, tables, px, py, n,
          image_width, spp, bounces, rand, xyz, steps, visits, res);
  return (int)cudaGetLastError();
}

}  // namespace

// cam [20], tri_pack [n_tris, 17], mat_pack [n_mats, 16], tables [5, 95],
// px/py [n] f32; rand [spp, 5 + 3 * bounces, n] f32 or null (hash draws);
// xyz [n, 3] f32 out; steps [n] int32 out (live ray-steps) or null.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int render_launch(const float* cam, uint32_t seed,
                             const float* tri_pack, int n_tris,
                             const float* mat_pack, int n_mats,
                             const float* tables, const float* px,
                             const float* py, int n, int image_width, int spp,
                             int bounces, const float* rand, float* xyz,
                             int* steps, void* stream) {
  return launch<false, false>(cam, seed, tri_pack, n_tris, Leaves{}, mat_pack,
                              n_mats, tables, px, py, n, image_width, spp,
                              bounces, rand, xyz, steps, nullptr, Residuals{},
                              stream);
}

// render_launch's arguments plus the residual outputs: hero, n_valid
// [spp, n] f32, power [spp, 7, n] f32, matres [spp, bounces, n] int32.
extern "C" int render_residuals_launch(
    const float* cam, uint32_t seed, const float* tri_pack, int n_tris,
    const float* mat_pack, int n_mats, const float* tables, const float* px,
    const float* py, int n, int image_width, int spp, int bounces,
    const float* rand, float* xyz, int* steps, float* hero, float* n_valid,
    float* power, int* matres, void* stream) {
  return launch<true, false>(cam, seed, tri_pack, n_tris, Leaves{}, mat_pack,
                             n_mats, tables, px, py, n, image_width, spp,
                             bounces, rand, xyz, steps, nullptr,
                             Residuals{hero, n_valid, power, matres}, stream);
}

// The leaf form: tri_pack [n_leaves * leaf_size, 18], leaf_pack
// [n_leaves, 8]; visits [n] int32 out (leaves entered) or null; the rest
// as render_launch.
extern "C" int render_leaves_launch(
    const float* cam, uint32_t seed, const float* tri_pack,
    const float* leaf_pack, int n_leaves, int leaf_size, const float* mat_pack,
    int n_mats, const float* tables, const float* px, const float* py, int n,
    int image_width, int spp, int bounces, const float* rand, float* xyz,
    int* steps, int* visits, void* stream) {
  return launch<false, true>(cam, seed, tri_pack, n_leaves * leaf_size,
                             Leaves{leaf_pack, n_leaves, leaf_size}, mat_pack,
                             n_mats, tables, px, py, n, image_width, spp,
                             bounces, rand, xyz, steps, visits, Residuals{},
                             stream);
}

// render_leaves_launch's arguments plus render_residuals_launch's outputs.
extern "C" int render_leaves_residuals_launch(
    const float* cam, uint32_t seed, const float* tri_pack,
    const float* leaf_pack, int n_leaves, int leaf_size, const float* mat_pack,
    int n_mats, const float* tables, const float* px, const float* py, int n,
    int image_width, int spp, int bounces, const float* rand, float* xyz,
    int* steps, int* visits, float* hero, float* n_valid, float* power,
    int* matres, void* stream) {
  return launch<true, true>(cam, seed, tri_pack, n_leaves * leaf_size,
                            Leaves{leaf_pack, n_leaves, leaf_size}, mat_pack,
                            n_mats, tables, px, py, n, image_width, spp,
                            bounces, rand, xyz, steps, visits,
                            Residuals{hero, n_valid, power, matres}, stream);
}
