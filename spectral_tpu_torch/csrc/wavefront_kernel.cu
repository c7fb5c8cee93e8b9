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
// ray-step ~340 flops of shading and the sweep's slab and triangle tests,
// leaf_sweep.cuh); the state adds 2 * 68 bytes per live ray-step (read,
// written) and the integration reads 40 bytes and writes 12 per ray, far
// below it. The `steps`, `visits`, `group_visits` and `top_visits` outputs
// ([spp, n] int32, indexed by orig) count each ray's live ray-steps and the
// leaves, groups and super-groups its sweeps entered. Design, right and
// simple first: no persistent threads, no queue of live rays; a dead ray's
// thread returns at once after writing its residual 0. The sweep's
// hierarchy (leaf_sweep.cuh) is what the tracing kernels' time goes to:
// each block stages the super-group table in shared memory beside the
// materials and curves, and reads triangles as 16-byte rows. Under
// __launch_bounds__(kBlock) ptxas keeps the two tracing kernels at 72-96
// registers and spills 96-236 bytes to L1; without the bounds, or with a
// minimum of one block an SM, they built to 121-140 registers, and with
// minimums of 6 or 8 blocks to 80 or 64; each measured slower (PERF.md).

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
  LeafScene lv;
  const float* mat;  // [n_mats, 16]
  int n_mats;
  const float* tables;  // [5, 95]
  const float* px;      // [n]
  const float* py;      // [n]
  int n, image_width, spp, bounces;
  const float* rand;  // [spp, 5 + 3 * bounces, n] or null (hash)
  uint32_t seed;
};

// Each per-ray counter output, or null.
struct Counters {
  int* steps;
  int* visits;
  int* group_visits;
  int* top_visits;
};

// Shared memory: the super-group table (float4 rows), the materials, the
// curves.
__device__ __forceinline__ void stage_scene(const Scene& sc, float4* s_top,
                                            float* s_mat, float* s_tab) {
  stage_tops(s_top, sc.lv);
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
                                     const float4* s_top, const float* s_mat,
                                     const Curves& cv, const Draws& u, int b,
                                     SweepCount& cnt) {
  const LeafHit h = nearest_hit_leaves(sc.lv, s_top, st.r.ox, st.r.oy,
                                       st.r.oz, st.r.dx, st.r.dy, st.r.dz, cnt);
  const Surface sf = h.hit ? leaf_surface(sc.lv, h.row) : Surface{};
  return shade(st, h.hit, h.front, h.t, sf, s_mat, cv, u(3 + 3 * b),
               u(4 + 3 * b), u(5 + 3 * b));
}

// The parts of a tracing kernel's shared memory (stage_scene).
__device__ __forceinline__ void scene_smem_parts(const Scene& sc, float4* smem,
                                                 float4*& s_top, float*& s_mat,
                                                 float*& s_tab) {
  s_top = smem;
  s_mat = reinterpret_cast<float*>(smem + top_smem(sc.lv) / sizeof(float4));
  s_tab = s_mat + sc.n_mats * kMatStride;
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

// Count a ray's sweep into its counters at index o (first: it is the
// ray's first sweep, so the counters are set, not added to).
__device__ __forceinline__ void count(const Counters& c, size_t o, bool first,
                                      const SweepCount& n) {
  if (c.steps) c.steps[o] = first ? 1 : c.steps[o] + 1;
  if (c.visits) c.visits[o] = first ? n.leaves : c.visits[o] + n.leaves;
  if (c.group_visits)
    c.group_visits[o] = first ? n.groups : c.group_visits[o] + n.groups;
  if (c.top_visits) c.top_visits[o] = first ? n.tops : c.top_visits[o] + n.tops;
}

template <bool kSaveResiduals>
__global__ void __launch_bounds__(kBlock) camera_bounce_kernel(
    const float* __restrict__ cam, Scene sc, float* __restrict__ state,
    int* __restrict__ matres, Counters cnt) {
  extern __shared__ float4 smem[];
  float4* s_top;
  float *s_mat, *s_tab;
  scene_smem_parts(sc, smem, s_top, s_mat, s_tab);
  stage_scene(sc, s_top, s_mat, s_tab);
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
  SweepCount n;
  const int mres = trace(sc, st, s_top, s_mat, cv, u, 0, n);
  if constexpr (kSaveResiduals) matres[(size_t)s * sc.bounces * sc.n + p] = mres;
  count(cnt, r, true, n);
  store_state(state, nrays, r, st, hero);
}

template <bool kSaveResiduals>
__global__ void __launch_bounds__(kBlock) bounce_kernel(
    Scene sc, int b, float* __restrict__ state, const int* __restrict__ orig,
    int* __restrict__ matres, Counters cnt) {
  extern __shared__ float4 smem[];
  float4* s_top;
  float *s_mat, *s_tab;
  scene_smem_parts(sc, smem, s_top, s_mat, s_tab);
  stage_scene(sc, s_top, s_mat, s_tab);
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
  SweepCount n;
  const int mres = trace(sc, st, s_top, s_mat, cv, ray_draws(sc, s, p), b, n);
  if constexpr (kSaveResiduals) matres[mi] = mres;
  count(cnt, o, false, n);
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

// Shared memory of a tracing kernel's block (stage_scene); above the
// default 48 KB a kernel must be allowed it first.
template <typename Kernel>
cudaError_t scene_smem(Kernel kernel, const Scene& sc, size_t& smem) {
  smem = top_smem(sc.lv) +
         sizeof(float) * ((size_t)sc.n_mats * kMatStride + 5 * kSamples);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

Scene make_scene(const float* rows, const int* ids, const float* leaf,
                 const float* group, const float* top, int n_leaves,
                 int leaf_size, int n_groups, int n_tops, const float* mat,
                 int n_mats, const float* tables, const float* px,
                 const float* py, int n, int image_width, int spp, int bounces,
                 const float* rand, uint32_t seed) {
  const LeafScene lv{reinterpret_cast<const float4*>(rows),
                     reinterpret_cast<const int2*>(ids),
                     reinterpret_cast<const float4*>(leaf),
                     reinterpret_cast<const float4*>(group),
                     reinterpret_cast<const float4*>(top),
                     n_leaves, leaf_size, n_groups, n_tops};
  return Scene{lv, mat, n_mats, tables, px, py, n, image_width, spp, bounces,
               rand, seed};
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, const Scene& sc, void* stream, Args... args) {
  const size_t nrays = (size_t)sc.spp * sc.n;
  if (nrays == 0) return 0;
  size_t smem;
  const cudaError_t e = scene_smem(kernel, sc, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid_of(nrays), kBlock, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// The leaf scene of the two tracing kernels (ops/cuda/render_kernel.py::
// leaf_tables): rows [n_leaves * leaf_size, 16] f32 (four float4 a
// triangle), ids [n_leaves * leaf_size, 2] int32 (material, original
// index), leaf [n_leaves, 8], group [n_groups, 8], top [n_tops, 8] f32
// (super-groups), every table 16-byte aligned; kFan (8) leaves a group and
// groups a super-group. Then mat [n_mats, 16], tables [5, 95],
// px/py [n] f32, rand [spp, 5 + 3 * bounces, n] f32 or null (hash draws of
// `seed`). state [17, spp * n] f32; matres [spp, bounces, n] int32 or null
// (no residuals); steps, visits, group_visits, top_visits [spp, n] int32 or
// null. Each launches on `stream` and returns its CUDA error (0 =
// launched).
#define SPT_SCENE_PARAMS                                                      \
  const float *rows, const int *ids, const float *leaf, const float *group,   \
      const float *top, int n_leaves, int leaf_size, int n_groups, int n_tops, \
      const float *mat, int n_mats,                                          \
      const float *tables, const float *px, const float *py, int n,          \
      int image_width, int spp, int bounces, const float *rand
#define SPT_SCENE_ARGS                                                     \
  rows, ids, leaf, group, top, n_leaves, leaf_size, n_groups, n_tops, mat, \
      n_mats, tables, px, py, n, image_width, spp, bounces, rand

extern "C" int wavefront_camera_launch(const float* cam, uint32_t seed,
                                       SPT_SCENE_PARAMS, float* state,
                                       int* matres, int* steps, int* visits,
                                       int* group_visits, int* top_visits,
                                       void* stream) {
  const Scene sc = make_scene(SPT_SCENE_ARGS, seed);
  const Counters cnt{steps, visits, group_visits, top_visits};
  if (matres)
    return launch(camera_bounce_kernel<true>, sc, stream, cam, sc, state, matres, cnt);
  return launch(camera_bounce_kernel<false>, sc, stream, cam, sc, state, matres, cnt);
}

// Bounce b >= 1 of the state in sorted order; orig [spp * n] int32 is each
// column's original sample-ray index.
extern "C" int wavefront_bounce_launch(uint32_t seed, SPT_SCENE_PARAMS, int b,
                                       float* state, const int* orig,
                                       int* matres, int* steps, int* visits,
                                       int* group_visits, int* top_visits,
                                       void* stream) {
  const Scene sc = make_scene(SPT_SCENE_ARGS, seed);
  const Counters cnt{steps, visits, group_visits, top_visits};
  if (matres)
    return launch(bounce_kernel<true>, sc, stream, sc, b, state, orig, matres, cnt);
  return launch(bounce_kernel<false>, sc, stream, sc, b, state, orig, matres, cnt);
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
