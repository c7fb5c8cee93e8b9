// The sorted per-bounce scheduler's three kernels, one thread per ray
// (sample-ray r = s * n + p of pixel p, sample s), on a ray state carried
// through device memory between launches.
//
// Replace the TPU kernels of spectral_tpu/ops/pallas/wavefront_kernel.py,
// launched by render_rays_wavefront :407:
// - camera_bounce_kernel: _camera_bounce_kernel :188 (pallas_call :533):
//   the camera ray, the hero wavelength and bounce 0;
// - bounce_kernel: _bounce_kernel :270 (pallas_call :570): one bounce of
//   the rays in sorted order; a ray that has ended passes through with
//   material residual 0 (:289-296);
// - integrate_kernel: _integrate_kernel :338 (pallas_call :625): the CIE
//   XYZ of the final state, nothing once the bounce limit is exhausted
//   (:348-349).
// Between launches, ops/cuda/wavefront_kernel.py sorts the rays by (dead,
// direction octant, Morton code of the origin) and gathers the state, so
// that the lanes of a warp sweep neighbouring rays of one direction octant
// and enter the same leaves. That glue is data movement, not arithmetic.
//
// Every operation on a path is path.cuh's and leaf_sweep.cuh's, the ones
// the leaf megakernel (render_kernel.cu, kLeaves) runs, so the two
// schedulers give bit-equal paths. Each ray carries its original index
// (orig): its draws are the megakernel's, hashed from (chunk seed, global
// pixel, sample, draw) or read from injected planes rand[s, j, p], never
// gathered; its counters and residuals are written at [s, ., p] of the
// original order. The JAX package instead feeds this scheduler host planes
// and scatters the material residual back after each launch.
//
// State: [17, nrays] f32, rows 0-2 origin, 3-5 direction, 6 hero, 7 alive
// (1 or 0), 8 n_valid, 9 previous triangle (always -1: the f32 sweep
// excludes none), 10-16 power. The bounce kernel updates it in place: each
// thread reads and writes its own column only.
//
// Bound on an H100: FP32 arithmetic, as the leaf megakernel's (per live
// ray-step ~340 flops of shading, ~25 per valid leaf's slab test and 51 per
// triangle of an entered leaf); the state adds 2 * 68 bytes per live
// ray-step (read, written) and the integration reads 40 bytes and writes 12
// per ray, far below it. The `steps` and `visits` outputs ([spp, n] int32,
// indexed by orig) count each ray's live ray-steps and entered leaves.
// Design, right and simple first: no persistent threads, no queue of live
// rays; a dead ray's thread returns at once after writing its residual 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "leaf_sweep.cuh"
#include "path.cuh"

namespace {

using namespace spt;

constexpr int kBlock = 128;
constexpr int kRowHero = 6, kRowAlive = 7, kRowNValid = 8, kRowPrev = 9,
              kRowPower = 10;

// The scene and draws every launch reads.
struct Scene {
  const float* tri;   // [n_leaves * leaf_size, 18]
  const float* leaf;  // [n_leaves, 8]
  int n_leaves, leaf_size;
  const float* mat;  // [n_mats, 16]
  int n_mats;
  const float* tables;  // [5, 95]
  const float* px;      // [n]
  const float* py;      // [n]
  int n, image_width, spp, bounces;
  const float* rand;  // [spp, 5 + 3 * bounces, n] or null (hash)
  uint32_t seed;
};

__device__ __forceinline__ void stage_scene(const Scene& sc, float* s_mat,
                                            float* s_tab) {
  stage(s_mat, sc.mat, sc.n_mats * kMatStride);
  stage(s_tab, sc.tables, 5 * kSamples);
  __syncthreads();
}

__device__ __forceinline__ Draws ray_draws(const Scene& sc, int s, int p) {
  return sample_draws(sc.rand, sc.n, p, s, 5 + 3 * sc.bounces,
                      pixel_key(sc.seed, sc.px[p], sc.py[p], sc.image_width));
}

// Nearest hit over the leaves, then shade: one bounce of a live path.
// Returns its material residual.
__device__ __forceinline__ int trace(const Scene& sc, Path& st,
                                     const float* s_mat, const Curves& cv,
                                     const Draws& u, int b, int& visits) {
  const LeafHit h = nearest_hit_leaves(sc.tri, sc.leaf, sc.n_leaves,
                                       sc.leaf_size, st.r.ox, st.r.oy, st.r.oz,
                                       st.r.dx, st.r.dy, st.r.dz, visits);
  const Surface sf =
      h.hit ? row_surface(sc.tri + (size_t)h.row * kLeafTriStride) : Surface{};
  return shade(st, h.hit, h.front, h.t, sf, s_mat, cv, u(3 + 3 * b),
               u(4 + 3 * b), u(5 + 3 * b));
}

__device__ __forceinline__ void store_state(float* __restrict__ state,
                                            size_t nrays, int i,
                                            const Path& st, float hero) {
  state[0 * nrays + i] = st.r.ox;
  state[1 * nrays + i] = st.r.oy;
  state[2 * nrays + i] = st.r.oz;
  state[3 * nrays + i] = st.r.dx;
  state[4 * nrays + i] = st.r.dy;
  state[5 * nrays + i] = st.r.dz;
  state[kRowHero * nrays + i] = hero;
  state[kRowAlive * nrays + i] = st.alive ? 1.0f : 0.0f;
  state[kRowNValid * nrays + i] = st.n_valid;
  state[kRowPrev * nrays + i] = -1.0f;
#pragma unroll
  for (int w = 0; w < kW; ++w) state[(kRowPower + w) * nrays + i] = st.power[w];
}

template <bool kSaveResiduals>
__global__ void __launch_bounds__(kBlock) camera_bounce_kernel(
    const float* __restrict__ cam, Scene sc, float* __restrict__ state,
    int* __restrict__ matres, int* __restrict__ steps,
    int* __restrict__ visits) {
  extern __shared__ float smem[];
  float* s_mat = smem;
  float* s_tab = s_mat + sc.n_mats * kMatStride;
  stage_scene(sc, s_mat, s_tab);
  const size_t nrays = (size_t)sc.spp * sc.n;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if ((size_t)r >= nrays) return;
  const int s = r / sc.n, p = r - s * sc.n;

  const Draws u = ray_draws(sc, s, p);
  Path st;
  start_path(st, camera_ray(load_camera(cam), sc.px[p], sc.py[p], u, sc.bounces));
  const float hero = hero_wavelength(u(2));
  Curves cv;
  hero_curves(hero, s_tab, cv);
  int n_visits = 0;
  const int mres = trace(sc, st, s_mat, cv, u, 0, n_visits);
  if constexpr (kSaveResiduals) matres[(size_t)s * sc.bounces * sc.n + p] = mres;
  if (steps) steps[r] = 1;
  if (visits) visits[r] = n_visits;
  store_state(state, nrays, r, st, hero);
}

template <bool kSaveResiduals>
__global__ void __launch_bounds__(kBlock) bounce_kernel(
    Scene sc, int b, float* __restrict__ state, const int* __restrict__ orig,
    int* __restrict__ matres, int* __restrict__ steps,
    int* __restrict__ visits) {
  extern __shared__ float smem[];
  float* s_mat = smem;
  float* s_tab = s_mat + sc.n_mats * kMatStride;
  stage_scene(sc, s_mat, s_tab);
  const size_t nrays = (size_t)sc.spp * sc.n;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if ((size_t)i >= nrays) return;
  const int o = orig[i];
  const int s = o / sc.n, p = o - s * sc.n;
  const size_t mi = ((size_t)s * sc.bounces + b) * sc.n + p;
  if (state[kRowAlive * nrays + i] == 0.0f) {
    // an ended path touches no material this bounce
    if constexpr (kSaveResiduals) matres[mi] = 0;
    return;
  }

  Path st;
  st.r = Ray{state[0 * nrays + i], state[1 * nrays + i], state[2 * nrays + i],
             state[3 * nrays + i], state[4 * nrays + i], state[5 * nrays + i]};
#pragma unroll
  for (int w = 0; w < kW; ++w) st.power[w] = state[(kRowPower + w) * nrays + i];
  st.n_valid = state[kRowNValid * nrays + i];
  st.alive = true;
  const float hero = state[kRowHero * nrays + i];
  Curves cv;
  hero_curves(hero, s_tab, cv);
  int n_visits = 0;
  const int mres = trace(sc, st, s_mat, cv, ray_draws(sc, s, p), b, n_visits);
  if constexpr (kSaveResiduals) matres[mi] = mres;
  if (steps) steps[o] += 1;
  if (visits) visits[o] += n_visits;
  store_state(state, nrays, i, st, hero);
}

template <bool kSaveResiduals>
__global__ void __launch_bounds__(kBlock) integrate_kernel(
    const float* __restrict__ tables, const float* __restrict__ state,
    const int* __restrict__ orig, int n, int spp, float* __restrict__ xyz,
    float* __restrict__ hero_out, float* __restrict__ nvalid_out,
    float* __restrict__ power_out) {
  __shared__ float s_tab[5 * kSamples];
  stage(s_tab, tables, 5 * kSamples);
  __syncthreads();
  const size_t nrays = (size_t)spp * n;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if ((size_t)i >= nrays) return;
  const int o = orig[i];
  const float hero = state[kRowHero * nrays + i];
  float n_valid = state[kRowNValid * nrays + i];
  // bounce-limit exhaustion contributes nothing (rendering.cu:38-39)
  if (state[kRowAlive * nrays + i] > 0.0f) n_valid = 0.0f;
  float power[kW];
#pragma unroll
  for (int w = 0; w < kW; ++w) power[w] = state[(kRowPower + w) * nrays + i];
  Curves cv;
  hero_curves(hero, s_tab, cv);
  float sx, sy, sz;
  path_xyz(power, n_valid, cv, s_tab, sx, sy, sz);
  xyz[3 * (size_t)o] = sx;
  xyz[3 * (size_t)o + 1] = sy;
  xyz[3 * (size_t)o + 2] = sz;
  if constexpr (kSaveResiduals) {
    // [spp, n] residuals: the flat index of (s, p) is o itself
    const int s = o / n, p = o - s * n;
    hero_out[o] = hero;
    nvalid_out[o] = n_valid;
#pragma unroll
    for (int w = 0; w < kW; ++w) power_out[((size_t)s * kW + w) * n + p] = power[w];
  }
}

int grid_of(size_t nrays) { return (int)((nrays + kBlock - 1) / kBlock); }

size_t scene_smem(int n_mats) {
  return sizeof(float) * ((size_t)n_mats * kMatStride + 5 * kSamples);
}

}  // namespace

// Scene arguments of the two tracing kernels: tri [n_leaves * leaf_size,
// 18], leaf [n_leaves, 8], mat [n_mats, 16], tables [5, 95], px/py [n] f32,
// rand [spp, 5 + 3 * bounces, n] f32 or null (hash draws of `seed`).
// state [17, spp * n] f32; matres [spp, bounces, n] int32 or null (no
// residuals); steps, visits [spp, n] int32 or null. Each launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int wavefront_camera_launch(
    const float* cam, uint32_t seed, const float* tri, const float* leaf,
    int n_leaves, int leaf_size, const float* mat, int n_mats,
    const float* tables, const float* px, const float* py, int n,
    int image_width, int spp, int bounces, const float* rand, float* state,
    int* matres, int* steps, int* visits, void* stream) {
  const size_t nrays = (size_t)spp * n;
  if (nrays == 0) return 0;
  const Scene sc{tri, leaf, n_leaves, leaf_size, mat, n_mats, tables, px, py,
                 n, image_width, spp, bounces, rand, seed};
  const size_t smem = scene_smem(n_mats);
  if (matres)
    camera_bounce_kernel<true><<<grid_of(nrays), kBlock, smem, (cudaStream_t)stream>>>(
        cam, sc, state, matres, steps, visits);
  else
    camera_bounce_kernel<false><<<grid_of(nrays), kBlock, smem, (cudaStream_t)stream>>>(
        cam, sc, state, matres, steps, visits);
  return (int)cudaGetLastError();
}

// Bounce b >= 1 of the state in sorted order; orig [spp * n] int32 is each
// column's original sample-ray index.
extern "C" int wavefront_bounce_launch(
    uint32_t seed, const float* tri, const float* leaf, int n_leaves,
    int leaf_size, const float* mat, int n_mats, const float* tables,
    const float* px, const float* py, int n, int image_width, int spp,
    int bounces, int b, const float* rand, float* state, const int* orig,
    int* matres, int* steps, int* visits, void* stream) {
  const size_t nrays = (size_t)spp * n;
  if (nrays == 0) return 0;
  const Scene sc{tri, leaf, n_leaves, leaf_size, mat, n_mats, tables, px, py,
                 n, image_width, spp, bounces, rand, seed};
  const size_t smem = scene_smem(n_mats);
  if (matres)
    bounce_kernel<true><<<grid_of(nrays), kBlock, smem, (cudaStream_t)stream>>>(
        sc, b, state, orig, matres, steps, visits);
  else
    bounce_kernel<false><<<grid_of(nrays), kBlock, smem, (cudaStream_t)stream>>>(
        sc, b, state, orig, matres, steps, visits);
  return (int)cudaGetLastError();
}

// XYZ [spp * n, 3] f32 of each sample-ray in original order; with hero
// non-null also the residuals hero, n_valid [spp, n] and power [spp, 7, n].
extern "C" int wavefront_integrate_launch(const float* tables,
                                          const float* state, const int* orig,
                                          int n, int spp, float* xyz,
                                          float* hero, float* n_valid,
                                          float* power, void* stream) {
  const size_t nrays = (size_t)spp * n;
  if (nrays == 0) return 0;
  if (hero)
    integrate_kernel<true><<<grid_of(nrays), kBlock, 0, (cudaStream_t)stream>>>(
        tables, state, orig, n, spp, xyz, hero, n_valid, power);
  else
    integrate_kernel<false><<<grid_of(nrays), kBlock, 0, (cudaStream_t)stream>>>(
        tables, state, orig, n, spp, xyz, hero, n_valid, power);
  return (int)cudaGetLastError();
}
