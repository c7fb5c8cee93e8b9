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
//
// Design. The scene (tri pack [T <= 128, 17], material pack [M, 16], the
// five 95-sample curves; <= ~11 KB) is staged in shared memory once per
// block and read as warp-uniform broadcasts; each pixel's XYZ is written by
// the one thread that traced it, with no atomics; no sorting of rays. The
// first design ran each sample's bounces in lock-step with its warp and
// read 17-float rows; on the default frame it took 11.3x its bound, for
// four reasons, and the design answers each:
// 1. Lock-step samples. A warp ran each sample until its longest path
//    ended, so lanes whose paths had ended idled through the sweep (about
//    half the lanes: ~5.2 live bounces of 10 on the default frame). Now the
//    lane regenerates: one loop over ray-steps per thread, and when a
//    lane's path ends (terminated, or the bounce limit) it finishes that
//    sample (bounce-limit rule, residual stores, XYZ added to its sum) and
//    starts its next sample at once, joining the next sweep; it leaves the
//    loop after its last sample. A pixel's samples still run in order and
//    its draws are indexed by (sample, draw), so every pixel takes the same
//    operations in the same order as before: the outputs are bit-equal to
//    the plain version. The lanes still in the loop are a mask, narrowed by
//    __ballot_sync as lanes leave, and the warp meets at __syncwarp(mask)
//    before each sweep (never with the full mask once a lane has left).
// 2. Scalar shared loads. A 17-float row is never 16-byte aligned, so the
//    sweep issued 16 scalar loads a triangle. The rows are restaged as four
//    float4, (n, offset) and (g_k, c_k) (hit.cuh::stage_rows), read as four
//    128-bit broadcasts; the material ids sit in an int array read on a
//    hit. The test's operations and their order are hit.cuh::tri_hit4's.
// 3. Latency with few warps: 127 registers x 128 threads left 16 warps an
//    SM to hide the sweep's divide and the SPD's sqrt and divide. The dense
//    forms ask for more blocks an SM (__launch_bounds__): the forward form
//    6 (80 registers, 24 warps), the residual form 8 (64 registers, 32
//    warps), each spilling the rest to local memory that L1 holds; each
//    count measured fastest for its form of those tried, 127 registers
//    included.
// 4. The wave tail: 360,000 px are 2,813 blocks over the card's slots, and a
//    warp ends with its busiest lane. The forward form runs a persistent
//    grid: one wave of blocks, each thread starting at its own pixel and
//    then taking whole pixels from a counter (one atomic a warp), so lanes
//    stay busy until the pixels run out. A pixel's samples still run in
//    order in one lane.
// Block sizes of 64 and 256 and unrolling the sweep by 2 measured no
// faster and were not kept. `warp_steps`, when given, receives each
// launched warp's count of sweeps: live ray-steps / (32 x warp sweeps) is
// the share of lanes that sweep a live path.
//
// The residual form (render_residuals_launch) replaces the same TPU kernel
// with save_residuals=True, launched by render_rays_pallas_residuals :2421
// (writes at :2029-2030, :2249-2258, :2286-2289). It is one template
// instantiation of the same source: kSaveResiduals adds the stores of the
// hero wavelength, n_valid, the final power and the per-bounce material
// residual, and nothing else; the layout stays [s][.][i], which the replay
// and the JAX layout read. Its bound adds the 4 * (2 + 7 + bounces)
// residual bytes written per sample-ray to the forward's operations. Under
// regeneration the lanes of a warp sit at different samples, so a warp's
// stores no longer fill 128 contiguous bytes; it regenerates all the same,
// because that measured faster than the lock-step loop with its coalesced
// stores. It keeps a grid of one thread a pixel: the persistent grid,
// which scatters a warp's pixels too, measured slower for it (PERF.md).
//
// The leaf form (kLeaves: render_leaves_launch and
// render_leaves_residuals_launch) replaces the same TPU kernel with
// use_bvh=True, whose nearest hit is _mxu_leaf_sweep :565, launched by the
// same two functions with a leaf pack (:2068-2088). Only the sweep
// differs: the leaf scene stays in device memory apart from its
// super-group table, which each block stages in shared memory, and a ray
// tests the K triangles of each leaf it enters under the group hierarchy
// (leaf_sweep.cuh, shared with the sorted kernels). It keeps the lock-step
// loop, which measured faster for it (PERF.md), and asks for 4 blocks an
// SM: at the default bounds the group-cull sweep built it to 182-183
// registers (2 blocks), and the cap of 128 measured faster. Its bound is
// FP32 arithmetic as well,
// counted from its data:
// per live ray-step ~340 flops of shading plus ~25 per slab test (every
// valid super-group, the groups of the super-groups entered, the leaves of
// the groups entered), 51 per triangle of an entered leaf, and ~340 per
// sample; the `visits` outputs count the leaves, groups and super-groups
// each pixel's rays entered.
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

// The shape of each form (see the notes above): whether a lane starts its
// next sample as soon as its path ends (else together with its warp once
// every lane's path has ended); whether the grid is persistent (one wave of
// blocks whose lanes take whole pixels from a shared counter); and how many
// blocks an SM must hold at once (4, 6 or 8 blocks of 128 threads cap a
// thread at 128, 80 or 64 registers, the compiler spilling the rest to
// local memory).
template <bool kSaveResiduals, bool kLeaves>
constexpr bool kRegenerate = !kLeaves;
template <bool kSaveResiduals, bool kLeaves>
constexpr bool kPersistent = !kLeaves && !kSaveResiduals;
template <bool kSaveResiduals, bool kLeaves>
constexpr int kMinBlocks = kLeaves ? 4 : kSaveResiduals ? 8 : 6;

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

// The kLeaves form's per-pixel counts of the boxes its sweeps entered, by
// level (leaves, groups, super-groups); each may be null.
struct BoxCounts {
  int* leaves;
  int* groups;
  int* tops;
};

// On the persistent grid, the lanes in `need` each take the next pixel,
// one atomic for the warp; the first pixel of every thread is its own index.
__device__ __forceinline__ int take_pixel(int* next_pixel, unsigned need,
                                          int lane) {
  const int leader = __ffs(need) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(next_pixel, __popc(need));
  base = __shfl_sync(need, base, leader);
  return gridDim.x * blockDim.x + base + __popc(need & ((1u << lane) - 1u));
}

template <bool kSaveResiduals, bool kLeaves>
__global__ void __launch_bounds__(kBlock, (kMinBlocks<kSaveResiduals, kLeaves>)) render_kernel(
    const float* __restrict__ cam, uint32_t seed,
    const float* __restrict__ tri_pack, int n_tris, LeafScene lv,
    const float* __restrict__ mat_pack, int n_mats,
    const float* __restrict__ tables, const float* __restrict__ px,
    const float* __restrict__ py, int n, int image_width, int spp, int bounces,
    const float* __restrict__ rand, float* __restrict__ xyz,
    int* __restrict__ steps, BoxCounts visits,
    int* __restrict__ warp_steps, int* __restrict__ next_pixel,
    Residuals res) {
  extern __shared__ float4 smem[];
  // the dense scene is restaged as float4 rows; of the leaf scene only the
  // super-group table is staged, the rest stays in device memory
  float4* s_top = smem;
  float4* s_rows = s_top + (kLeaves ? top_smem(lv) / sizeof(float4) : 0);
  int* s_mid = reinterpret_cast<int*>(s_rows + (kLeaves ? 0 : 4 * n_tris));
  float* s_mat = reinterpret_cast<float*>(s_mid + (kLeaves ? 0 : n_tris));
  float* s_tab = s_mat + n_mats * kMatStride;
  if constexpr (kLeaves) stage_tops(s_top, lv);
  if constexpr (!kLeaves) stage_rows(s_rows, s_mid, tri_pack, n_tris, kTriStride);
  stage(s_mat, mat_pack, n_mats * kMatStride);
  stage(s_tab, tables, 5 * kSamples);
  __syncthreads();

  const int thread = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int i = thread;  // the lane's pixel
  unsigned mask = __ballot_sync(0xffffffffu, i < n);  // lanes in the loop
  if (i >= n) return;

  const Camera c = load_camera(cam);
  const int n_draws = 5 + 3 * bounces;
  float pxi, pyi, accx, accy, accz;
  uint32_t key_pixel;
  int live_steps, s, b = 0;  // s: the sample in flight, b: its bounce
  SweepCount boxes;  // the leaf form's boxes entered
  int sweeps = 0;
  bool tracing = false;
  Draws u;
  Path st;
  Curves cv;
  auto open_pixel = [&]() {
    pxi = px[i];
    pyi = py[i];
    key_pixel = pixel_key(seed, pxi, pyi, image_width);
    accx = accy = accz = 0.0f;
    live_steps = s = 0;
    boxes = SweepCount{};
  };
  auto close_pixel = [&]() {
    xyz[3 * i] = accx;
    xyz[3 * i + 1] = accy;
    xyz[3 * i + 2] = accz;
    if (steps) steps[i] = live_steps;
    if constexpr (kLeaves) {
      if (visits.leaves) visits.leaves[i] = boxes.leaves;
      if (visits.groups) visits.groups[i] = boxes.groups;
      if (visits.tops) visits.tops[i] = boxes.tops;
    }
  };
  open_pixel();
  for (;;) {
    if constexpr (kPersistent<kSaveResiduals, kLeaves>) {
      // a lane whose pixel is finished writes it and takes the next one
      const bool finished = !tracing && s == spp;
      const unsigned need = __ballot_sync(mask, finished);
      if (finished) {
        close_pixel();
        i = take_pixel(next_pixel, need, lane);
        if (i < n) open_pixel();
      }
    }
    bool begin = !tracing && s < spp;
    if constexpr (!kRegenerate<kSaveResiduals, kLeaves>) {
      const bool idle = __all_sync(mask, !tracing);
      begin = begin && idle;
    }
    if (begin) {
      // sample s: its draws, camera ray and hero wavelengths
      u = sample_draws(rand, n, i, s, n_draws, key_pixel);
      start_path(st, camera_ray(c, pxi, pyi, u, bounces));
      const float hero = hero_wavelength(u(2));
      if constexpr (kSaveResiduals) res.hero[(size_t)s * n + i] = hero;
      hero_curves(hero, s_tab, cv);
      b = 0;
      tracing = true;
    }
    const bool done = !tracing && s == spp;
    const unsigned staying = __ballot_sync(mask, !done);
    if (done) {
      // the last lanes out write their warp's count of sweeps
      if (warp_steps && staying == 0 && lane == __ffs(mask) - 1)
        warp_steps[thread >> 5] = sweeps;
      break;
    }
    mask = staying;
    __syncwarp(mask);
    ++sweeps;
    if (!tracing) continue;  // lock-step: waits for the warp

    ++live_steps;
    bool hit, front;
    float t;
    Surface sf{};
    if constexpr (kLeaves) {
      const LeafHit h = nearest_hit_leaves(lv, s_top, st.r.ox, st.r.oy,
                                           st.r.oz, st.r.dx, st.r.dy, st.r.dz,
                                           boxes);
      hit = h.hit, front = h.front, t = h.t;
      if (hit) sf = leaf_surface(lv, h.row);
    } else {
      const NearestHit h = nearest_hit_rows(s_rows, n_tris, st.r.ox, st.r.oy,
                                            st.r.oz, st.r.dx, st.r.dy, st.r.dz);
      hit = h.hit, front = h.front, t = h.t;
      if (hit) {
        const float4 r0 = s_rows[4 * h.idx];
        sf = Surface{r0.x, r0.y, r0.z, s_mid[h.idx]};
      }
    }
    const int mres = shade(st, hit, front, t, sf, s_mat, cv, u(3 + 3 * b),
                           u(4 + 3 * b), u(5 + 3 * b));
    if constexpr (kSaveResiduals)
      res.matres[((size_t)s * bounces + b) * n + i] = mres;
    if (++b < bounces && st.alive) continue;

    // the path has ended: finish sample s
    // bounce-limit exhaustion contributes nothing (rendering.cu:38-39)
    if (st.alive) st.n_valid = 0.0f;
    if constexpr (kSaveResiduals) {
      // the JAX kernel keeps an ended path frozen and records "none" for
      // each later bounce; the buffer is not zeroed beforehand
      for (; b < bounces; ++b) res.matres[((size_t)s * bounces + b) * n + i] = 0;
      res.n_valid[(size_t)s * n + i] = st.n_valid;
#pragma unroll
      for (int w = 0; w < kW; ++w) res.power[((size_t)s * kW + w) * n + i] = st.power[w];
    }
    float sx_, sy_, sz_;
    path_xyz(st.power, st.n_valid, cv, s_tab, sx_, sy_, sz_);
    accx = accx + sx_;
    accy = accy + sy_;
    accz = accz + sz_;
    ++s;
    tracing = false;
  }

  if constexpr (!kPersistent<kSaveResiduals, kLeaves>) close_pixel();
}

template <bool kSaveResiduals, bool kLeaves>
int launch(const float* cam, uint32_t seed, const float* tri_pack, int n_tris,
           const LeafScene& lv, const float* mat_pack, int n_mats,
           const float* tables, const float* px, const float* py, int n,
           int image_width, int spp, int bounces, const float* rand,
           float* xyz, int* steps, BoxCounts visits, int* warp_steps,
           int* next_pixel, Residuals res, void* stream) {
  if (n <= 0) return 0;
  // the super-group table of the leaf scene, or the float4 rows and int
  // material ids of the dense scene; then the floats
  const size_t smem =
      (kLeaves ? top_smem(lv)
               : (size_t)n_tris * (4 * sizeof(float4) + sizeof(int))) +
      sizeof(float) * ((size_t)n_mats * kMatStride + 5 * kSamples);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        render_kernel<kSaveResiduals, kLeaves>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int grid = (n + kBlock - 1) / kBlock;
  if (kPersistent<kSaveResiduals, kLeaves>) {
    // one wave: as many blocks as the card holds at once
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, render_kernel<kSaveResiduals, kLeaves>, kBlock, smem);
    if (e != cudaSuccess) return (int)e;
    if (sms * per_sm > 0 && sms * per_sm < grid) grid = sms * per_sm;
  }
  render_kernel<kSaveResiduals, kLeaves>
      <<<grid, kBlock, smem, (cudaStream_t)stream>>>(
          cam, seed, tri_pack, n_tris, lv, mat_pack, n_mats, tables, px, py, n,
          image_width, spp, bounces, rand, xyz, steps, visits, warp_steps,
          next_pixel, res);
  return (int)cudaGetLastError();
}

LeafScene leaf_scene(const float* rows, const int* ids, const float* leaf,
                     const float* group, const float* top, int n_leaves,
                     int leaf_size, int n_groups, int n_tops) {
  return LeafScene{reinterpret_cast<const float4*>(rows),
                   reinterpret_cast<const int2*>(ids),
                   reinterpret_cast<const float4*>(leaf),
                   reinterpret_cast<const float4*>(group),
                   reinterpret_cast<const float4*>(top),
                   n_leaves, leaf_size, n_groups, n_tops};
}

}  // namespace

// cam [20], tri_pack [n_tris, 17], mat_pack [n_mats, 16], tables [5, 95],
// px/py [n] f32; rand [spp, 5 + 3 * bounces, n] f32 or null (hash draws);
// xyz [n, 3] f32 out; steps [n] int32 out (live ray-steps) or null;
// warp_steps [ceil(n / 32)] int32 out (sweeps of each launched warp; the
// persistent grid leaves the entries of warps it does not launch as they
// were) or null; next_pixel: one int32, 0 before the launch (the persistent
// grid's counter). Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int render_launch(const float* cam, uint32_t seed,
                             const float* tri_pack, int n_tris,
                             const float* mat_pack, int n_mats,
                             const float* tables, const float* px,
                             const float* py, int n, int image_width, int spp,
                             int bounces, const float* rand, float* xyz,
                             int* steps, int* warp_steps, int* next_pixel,
                             void* stream) {
  return launch<false, false>(cam, seed, tri_pack, n_tris, LeafScene{},
                              mat_pack, n_mats, tables, px, py, n, image_width,
                              spp, bounces, rand, xyz, steps, BoxCounts{},
                              warp_steps, next_pixel, Residuals{}, stream);
}

// render_launch's arguments, without next_pixel, plus the residual outputs:
// hero, n_valid [spp, n] f32, power [spp, 7, n] f32, matres [spp, bounces,
// n] int32.
extern "C" int render_residuals_launch(
    const float* cam, uint32_t seed, const float* tri_pack, int n_tris,
    const float* mat_pack, int n_mats, const float* tables, const float* px,
    const float* py, int n, int image_width, int spp, int bounces,
    const float* rand, float* xyz, int* steps, int* warp_steps, float* hero,
    float* n_valid, float* power, int* matres, void* stream) {
  return launch<true, false>(cam, seed, tri_pack, n_tris, LeafScene{},
                             mat_pack, n_mats, tables, px, py, n, image_width,
                             spp, bounces, rand, xyz, steps, BoxCounts{},
                             warp_steps, nullptr,
                             Residuals{hero, n_valid, power, matres}, stream);
}

// The leaf form: the leaf scene as the sorted kernels take it
// (wavefront_kernel.cu: rows, ids, leaf, group, top and their sizes);
// visits, group_visits, top_visits [n] int32 out (leaves, groups and
// super-groups entered) or null; the rest as render_launch, without
// warp_steps.
extern "C" int render_leaves_launch(
    const float* cam, uint32_t seed, const float* rows, const int* ids,
    const float* leaf, const float* group, const float* top, int n_leaves,
    int leaf_size, int n_groups, int n_tops,
    const float* mat_pack, int n_mats, const float* tables, const float* px,
    const float* py, int n, int image_width, int spp, int bounces,
    const float* rand, float* xyz, int* steps, int* visits, int* group_visits,
    int* top_visits, void* stream) {
  return launch<false, true>(
      cam, seed, nullptr, n_leaves * leaf_size,
      leaf_scene(rows, ids, leaf, group, top, n_leaves, leaf_size, n_groups,
                 n_tops),
      mat_pack, n_mats, tables, px, py, n, image_width, spp, bounces, rand, xyz,
      steps, BoxCounts{visits, group_visits, top_visits}, nullptr, nullptr,
      Residuals{}, stream);
}

// render_leaves_launch's arguments plus render_residuals_launch's outputs.
extern "C" int render_leaves_residuals_launch(
    const float* cam, uint32_t seed, const float* rows, const int* ids,
    const float* leaf, const float* group, const float* top, int n_leaves,
    int leaf_size, int n_groups, int n_tops,
    const float* mat_pack, int n_mats, const float* tables, const float* px,
    const float* py, int n, int image_width, int spp, int bounces,
    const float* rand, float* xyz, int* steps, int* visits, int* group_visits,
    int* top_visits, float* hero, float* n_valid, float* power, int* matres,
    void* stream) {
  return launch<true, true>(
      cam, seed, nullptr, n_leaves * leaf_size,
      leaf_scene(rows, ids, leaf, group, top, n_leaves, leaf_size, n_groups,
                 n_tops),
      mat_pack, n_mats, tables, px, py, n, image_width, spp, bounces, rand, xyz,
      steps, BoxCounts{visits, group_visits, top_visits}, nullptr, nullptr,
      Residuals{hero, n_valid, power, matres}, stream);
}
