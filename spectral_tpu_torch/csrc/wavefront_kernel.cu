// The sorted per-bounce scheduler's three kernels, over the rays
// (sample-ray r = s * n + p of pixel p, sample s) of a ray state carried
// through device memory between launches, and the integrate step that ends
// a frame.
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
//   (:348-349), and with it the un-sort and the ascending spp sum that
//   follow that kernel in XLA (:639-642): the integrate step, XYZ a pixel
//   out (integrate_kernel and sum_slots_kernel).
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
// excludes none), 10-16 power. The bounce kernel updates it in place: a
// lane reads and writes only the columns it takes.
//
// Bound on an H100: FP32 arithmetic for the tracing kernels, as the leaf
// megakernel's (per live ray-step ~340 flops of shading and the sweep's
// slab and triangle tests, leaf_sweep.cuh); the state adds 2 * 68 bytes
// per live ray-step (read, written), far below it. The integrate step is
// bound by bytes: 44 read a sample-ray (10 state rows and orig) and 12
// written a pixel, and 36 more written a sample-ray in the residual form.
// Its design: coalesced state reads in sorted order, the CIE rows paired
// in shared memory, one 16-byte scattered store a sample-ray into a slot,
// and the spp sum over the slots, which are still in L2, in a second
// launch of one thread a pixel (integrate_kernel, sum_slots_kernel). The
// `steps`, `visits`, `group_visits` and `top_visits` outputs ([spp, n]
// int32, indexed by orig) count each ray's live ray-steps and the leaves,
// groups and super-groups its sweeps entered.
//
// The tracing kernels (trace_columns). Their time goes to the sweep
// (leaf_sweep.cuh), whose work a ray is very uneven: on the 200k field a
// bounce ray enters 2 to ~200 leaves. The first design gave each ray a
// thread on a grid of one thread a ray: a warp ended with its busiest lane,
// and its lanes ran their boxes and leaves in passes of their own, so 0.19-
// 0.20 of the lanes were at work in a pass (PERF.md). Now the grid is
// persistent, one wave of blocks, and a lane whose ray is done shades it
// and takes the next sorted column from a counter (one atomic for the
// warp's lanes, as the dense megakernel's take_pixel). The ray's walk is
// resumable (LeafWalk) and the warp runs it in passes: a leaf is tested by
// kLeafLanes lanes together for the lane whose walk waits on it
// (walk_leaves), box tests by each lane for itself (walk_boxes) or, once
// every column is taken and lanes stand idle, by eight lanes a batch
// (walk_boxes_together), which shortens the launch's last rays. Each ray
// enters the same boxes in the same order as nearest_hit_leaves's, so the
// state, residuals and counters are the one-thread-a-ray kernels', bit for
// bit; only which lane works on a ray, and when, changes. A lane runs no
// loop of its own between two of the warp's shuffles and votes, and the
// warp meets at __syncwarp() before each: a walk_next with a loop of its
// own left lanes at other shuffles and votes now and then, so that a warp
// split, took a column twice or hung. Measured and not kept (PERF.md):
// runs of 32-128 sorted columns a take (fewer runs a warp, a longer tail),
// each lane testing its own leaves, 16, 8 or 2 lanes a leaf, box tests by
// eight lanes a batch in every pass, a minimum of 4 blocks an SM (no
// faster; it made the camera kernel spill) or 5 (slower), and end passes
// once 1/8, 3/8 or 1/2 of the lanes wait (1/4 is kept; 1/8 and 3/8 within
// the runs' spread of it). The tracing kernels build to 122-148
// registers with no spill (3-4 blocks an SM).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "leaf_sweep.cuh"
#include "path.cuh"

namespace {

using namespace spt;

constexpr int kBlock = 128;
constexpr int kIntegrateBlock = 256;
// The tracing kernels' loop (trace_columns): the share of the lanes with a
// ray that wait for an end pass before it runs.
constexpr int kShadeNum = 1, kShadeDen = 4;
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

// All 32 lanes call this together. The lanes of `need` take the next
// columns, one each in lane order, with one atomic for the warp (as the
// dense megakernel's take_pixel); -1 once every column is taken.
__device__ __forceinline__ int take_column(int* next_col, int nrays,
                                           unsigned need, int lane) {
  const int leader = __ffs(need) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(next_col, __popc(need));
  __syncwarp();
  base = __shfl_sync(0xffffffffu, base, leader);
  const int c = base + __popc(need & ((1u << lane) - 1u));
  return c < nrays ? c : -1;
}

// The tracing kernels' loop, on a persistent grid: one bounce (bounce b;
// the camera ray and bounce 0 with kCamera) of every column of the state.
// Each lane holds one ray's walk (leaf_sweep.cuh::LeafWalk) and the warp
// runs it in passes. A walking pass runs the units the walks wait on: the
// leaves, kLeafLanes lanes a leaf (walk_leaves), then the box tests, each
// lane its own (walk_boxes) or, once every column is taken and lanes stand
// idle, the warp's batches four at a time (walk_boxes_together). Lanes
// whose walk is over wait for an end pass, which runs once they are
// kShadeNum / kShadeDen of the lanes with a ray or no lane walks: they
// shade their rays, write their columns and take the next columns, one
// atomic for the warp. A column whose path has ended (sorted last) is
// passed over at once: residual 0, no walk. Lanes without a ray stay in
// the loop, and help, until the warp's last ray is done. warp_passes, when
// given, gets the warp's passes added to [0] and the lanes at work in them
// to [1]: a pass's lanes at work are the lanes that shade, test their own
// boxes, or test a leaf or a box for a lane.
template <bool kCamera, bool kSaveResiduals>
__device__ __forceinline__ void trace_columns(
    const Scene& sc, int b, const float* __restrict__ cam,
    float* __restrict__ state, const int* __restrict__ orig,
    int* __restrict__ matres, const Counters& cnt, int* next_col,
    unsigned long long* warp_passes) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int kLeafGroups = 32 / kLeafLanes;
  extern __shared__ float4 smem[];
  float4* s_top;
  float *s_mat, *s_tab;
  scene_smem_parts(sc, smem, s_top, s_mat, s_tab);
  stage_scene(sc, s_top, s_mat, s_tab);
  const int nrays = sc.spp * sc.n;
  const int lane = threadIdx.x & 31;
  bool exhausted = false;  // every column is taken (the same in each lane)
  int col = -1;            // the lane's column, -1 without a ray
  LeafWalk w = {};
  w.unit = kUnitEnd;
  unsigned fin = kAll;  // the lanes of an end pass (all lanes at first)
  unsigned done = 0;    // lanes whose walk is over
  long long passes = 0, at_work = 0;
  for (;;) {
    // the warp meets before each pass: every shuffle and vote below is
    // made by all 32 lanes together
    __syncwarp();
    if (fin) {
      ++passes;
      at_work += __popc(done);
      if (w.unit == kUnitEnd && col >= 0) {
        // shade the finished ray and write its column
        const int o = kCamera ? col : orig[col];
        const int s = o / sc.n, p = o - s * sc.n;
        const Draws u = ray_draws(sc, s, p);
        Path st;
        float hero;
        const Ray r{w.ox, w.oy, w.oz, w.dx, w.dy, w.dz};
        if constexpr (kCamera) {
          start_path(st, r);
          hero = hero_wavelength(u(2));
        } else {
          st.r = r;
#pragma unroll
          for (int k = 0; k < kW; ++k)
            st.power[k] = state[(size_t)(kRowPower + k) * nrays + col];
          st.n_valid = state[(size_t)kRowNValid * nrays + col];
          st.alive = true;
          hero = state[(size_t)kRowHero * nrays + col];
        }
        Curves cv;
        hero_curves(hero, s_tab, cv);
        const Surface sf = w.h.hit ? leaf_surface(sc.lv, w.h.row) : Surface{};
        const int mres = shade(st, w.h.hit, w.h.front, w.h.t, sf, s_mat, cv,
                               u(3 + 3 * b), u(4 + 3 * b), u(5 + 3 * b));
        if constexpr (kSaveResiduals)
          matres[((size_t)s * sc.bounces + b) * sc.n + p] = mres;
        count(cnt, o, kCamera, w.cnt);
        store_state(state, nrays, col, st, hero);
        col = -1;
      }
      __syncwarp();
      // the lanes without a ray take the next live columns
      for (unsigned need = exhausted ? 0u : fin; need;) {
        const int c = take_column(next_col, nrays, need, lane);
        bool dead = false;
        if ((need >> lane) & 1u) {
          col = c;
          if (c < 0) {
          } else if constexpr (kCamera) {
            const int s = c / sc.n, p = c - s * sc.n;
            const Ray r = camera_ray(load_camera(cam), sc.px[p], sc.py[p],
                                     ray_draws(sc, s, p), sc.bounces);
            walk_start(sc.lv, w, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz);
          } else if (state[(size_t)kRowAlive * nrays + c] == 0.0f) {
            // an ended path touches no material this bounce
            dead = true;
            if constexpr (kSaveResiduals) {
              const int o = orig[c];
              const int s = o / sc.n, p = o - s * sc.n;
              matres[((size_t)s * sc.bounces + b) * sc.n + p] = 0;
            }
          } else {
            walk_start(sc.lv, w, state[c], state[(size_t)nrays + c],
                       state[2 * (size_t)nrays + c], state[3 * (size_t)nrays + c],
                       state[4 * (size_t)nrays + c], state[5 * (size_t)nrays + c]);
          }
        }
        __syncwarp();
        exhausted = __any_sync(kAll, ((need >> lane) & 1u) && c < 0);
        need = __ballot_sync(kAll, dead);
      }
      if (col < 0) w.unit = kUnitEnd;
    } else {
      const unsigned leaf = __ballot_sync(kAll, col >= 0 && w.unit == kUnitLeaf);
      if (leaf) walk_leaves(sc.lv, w, leaf, lane);
      const unsigned box = __ballot_sync(kAll, col >= 0 && w.unit == kUnitBoxes);
      if (exhausted) {
        if (box) walk_boxes_together(sc.lv, s_top, w, box, lane);
      } else if ((box >> lane) & 1u) {
        walk_boxes(sc.lv, s_top, w);
      }
      const int n_leaf = __popc(leaf), n_box = __popc(box);
      passes += (n_leaf + kLeafGroups - 1) / kLeafGroups +
                (exhausted ? (n_box + 3) / 4 : box != 0);
      at_work += kLeafLanes * n_leaf + (exhausted ? kFan * n_box : n_box);
    }
    __syncwarp();
    const unsigned busy = __ballot_sync(kAll, col >= 0);
    done = __ballot_sync(kAll, col >= 0 && w.unit == kUnitEnd);
    if (!busy) {
      if (warp_passes && lane == 0) {
        atomicAdd(warp_passes, (unsigned long long)passes);
        atomicAdd(warp_passes + 1, (unsigned long long)at_work);
      }
      return;
    }
    const int n_busy = __popc(busy), n_done = __popc(done);
    fin = n_done == n_busy || n_done * kShadeDen >= n_busy * kShadeNum
              ? done | (exhausted ? 0u : ~busy)
              : 0u;
  }
}

template <bool kSaveResiduals>
__global__ void __launch_bounds__(kBlock) camera_bounce_kernel(
    const float* __restrict__ cam, Scene sc, float* __restrict__ state,
    int* __restrict__ matres, Counters cnt, int* next_col,
    unsigned long long* warp_passes) {
  trace_columns<true, kSaveResiduals>(sc, 0, cam, state, nullptr, matres, cnt,
                                      next_col, warp_passes);
}

template <bool kSaveResiduals>
__global__ void __launch_bounds__(kBlock) bounce_kernel(
    Scene sc, int b, float* __restrict__ state, const int* __restrict__ orig,
    int* __restrict__ matres, Counters cnt, int* next_col,
    unsigned long long* warp_passes) {
  trace_columns<false, kSaveResiduals>(sc, b, nullptr, state, orig, matres,
                                       cnt, next_col, warp_passes);
}

// The integrate step, in two launches. integrate_kernel: one thread a
// sorted sample-ray reads its state (coalesced), computes its XYZ and
// stores it as one 16-byte slot at [s, p] of its original index o = s * n
// + p, the only scattered store of the forward form. sum_slots_kernel: one
// thread a pixel adds its slots from s = 0, starting at +0.0 as the plain
// sum does, so the sum is the plain version's bit for bit. Measured and
// not kept (PERF.md): one launch in which each pixel's last
// sample-ray, found by an atomic ticket, adds the slots (the fences and
// atomics cost more than the second launch), and four sorted rays a
// thread read as float4 rows.
template <bool kSaveResiduals>
__global__ void __launch_bounds__(kIntegrateBlock) integrate_kernel(
    const float* __restrict__ tables, const float* __restrict__ state,
    const int* __restrict__ orig, int n, int spp, float4* __restrict__ slot,
    float* __restrict__ hero_out, float* __restrict__ nvalid_out,
    float* __restrict__ power_out) {
  // CIE x and y as (row[c], row[c + 1]) pairs of each cell c, z likewise:
  // three table reads a wavelength instead of six
  __shared__ float4 s_xy[kSamples - 1];
  __shared__ float2 s_z[kSamples - 1];
  for (int c = threadIdx.x; c < kSamples - 1; c += blockDim.x) {
    const float* x = tables + kCieX * kSamples + c;
    const float* y = tables + kCieY * kSamples + c;
    const float* z = tables + kCieZ * kSamples + c;
    s_xy[c] = make_float4(x[0], x[1], y[0], y[1]);
    s_z[c] = make_float2(z[0], z[1]);
  }
  __syncthreads();
  const size_t nrays = (size_t)spp * n;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nrays) return;
  const int o = orig[i];
  const float hero = state[kRowHero * nrays + i];
  float n_valid = state[kRowNValid * nrays + i];
  // bounce-limit exhaustion contributes nothing (rendering.cu:38-39)
  if (state[kRowAlive * nrays + i] > 0.0f) n_valid = 0.0f;
  float power[kW];
#pragma unroll
  for (int w = 0; w < kW; ++w) power[w] = state[(kRowPower + w) * nrays + i];
  // XYZ of the sample-ray: path.cuh::path_xyz, each lut read as a pair
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    float lam, frac;
    int cell;
    comb_cell(hero, w, lam, cell, frac);
    const float contrib = power[w] * ((float)w < n_valid ? kDelta : 0.0f);
    const float4 xy = s_xy[cell];
    const float2 z = s_z[cell];
    sx = fmaf(contrib, fmaf(1.0f - frac, xy.x, frac * xy.y), sx);
    sy = fmaf(contrib, fmaf(1.0f - frac, xy.z, frac * xy.w), sy);
    sz = fmaf(contrib, fmaf(1.0f - frac, z.x, frac * z.y), sz);
  }
  slot[o] = make_float4(sx, sy, sz, 0.0f);
  if constexpr (kSaveResiduals) {
    // [spp, n] residuals: the flat index of (s, p) is o itself
    const int s = o / n, p = o - s * n;
    hero_out[o] = hero;
    nvalid_out[o] = n_valid;
#pragma unroll
    for (int w = 0; w < kW; ++w)
      power_out[((size_t)s * kW + w) * n + p] = power[w];
  }
}

__global__ void __launch_bounds__(kIntegrateBlock)
    sum_slots_kernel(const float4* __restrict__ slot, int n, int spp,
                     float* __restrict__ xyz) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  for (int s = 0; s < spp; ++s) {
    const float4 v = slot[(size_t)s * n + p];
    ax = ax + v.x;
    ay = ay + v.y;
    az = az + v.z;
  }
  xyz[3 * (size_t)p] = ax;
  xyz[3 * (size_t)p + 1] = ay;
  xyz[3 * (size_t)p + 2] = az;
}

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

// One wave of blocks, as many as the card holds at once, and no more than
// the columns fill.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, const Scene& sc, void* stream, Args... args) {
  const size_t nrays = (size_t)sc.spp * sc.n;
  if (nrays == 0) return 0;
  size_t smem;
  cudaError_t e = scene_smem(kernel, sc, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (int)std::min<size_t>((nrays + kBlock - 1) / kBlock,
                                         (size_t)std::max(sms * per_sm, 1));
  kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(args...);
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
// null. next_col: one int32, 0 before the launch (the columns taken);
// warp_passes: two uint64, to which the launch adds its warps' passes and
// their lanes at work (trace_columns), or null. Each launches on `stream`
// and returns its CUDA error (0 = launched).
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
                                       int* next_col,
                                       unsigned long long* warp_passes,
                                       void* stream) {
  const Scene sc = make_scene(SPT_SCENE_ARGS, seed);
  const Counters cnt{steps, visits, group_visits, top_visits};
  if (matres)
    return launch(camera_bounce_kernel<true>, sc, stream, cam, sc, state,
                  matres, cnt, next_col, warp_passes);
  return launch(camera_bounce_kernel<false>, sc, stream, cam, sc, state,
                matres, cnt, next_col, warp_passes);
}

// Bounce b >= 1 of the state in sorted order; orig [spp * n] int32 is each
// column's original sample-ray index.
extern "C" int wavefront_bounce_launch(uint32_t seed, SPT_SCENE_PARAMS, int b,
                                       float* state, const int* orig,
                                       int* matres, int* steps, int* visits,
                                       int* group_visits, int* top_visits,
                                       int* next_col,
                                       unsigned long long* warp_passes,
                                       void* stream) {
  const Scene sc = make_scene(SPT_SCENE_ARGS, seed);
  const Counters cnt{steps, visits, group_visits, top_visits};
  if (matres)
    return launch(bounce_kernel<true>, sc, stream, sc, b, state, orig, matres,
                  cnt, next_col, warp_passes);
  return launch(bounce_kernel<false>, sc, stream, sc, b, state, orig, matres,
                cnt, next_col, warp_passes);
}

// XYZ [n, 3] f32 of each pixel, summed over its spp samples in ascending
// order; with hero non-null also the residuals hero, n_valid [spp, n] and
// power [spp, 7, n] in original order. slot: [spp * n] float4 scratch.
extern "C" int wavefront_integrate_launch(const float* tables,
                                          const float* state, const int* orig,
                                          int n, int spp, float* slot,
                                          float* xyz, float* hero,
                                          float* n_valid, float* power,
                                          void* stream) {
  const size_t nrays = (size_t)spp * n;
  if (nrays == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  float4* slots = reinterpret_cast<float4*>(slot);
  const int grid = (int)((nrays + kIntegrateBlock - 1) / kIntegrateBlock);
  const auto kernel = hero ? integrate_kernel<true> : integrate_kernel<false>;
  kernel<<<grid, kIntegrateBlock, 0, st>>>(tables, state, orig, n, spp, slots,
                                           hero, n_valid, power);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_slots_kernel<<<(n + kIntegrateBlock - 1) / kIntegrateBlock,
                     kIntegrateBlock, 0, st>>>(slots, n, spp, xyz);
  return (int)cudaGetLastError();
}
