// Dense ray-triangle nearest hit, kRays rays a thread, over any number of
// triangles.
//
// Replaces the TPU kernel spectral_tpu/ops/pallas/intersect_kernel.py
// :52 _intersect_kernel (launched by intersect_pallas :108). Its sweep runs
// hit.cuh's tri_hit4 over the float4 rows the render megakernel's dense
// sweep reads, triangle by triangle with a strict <, so t, idx, hit and
// front are the render sweep's and the plain version's
// (ops/intersect.py::nearest_hit) bit for bit. It is also the selection of
// the XLA-style renderer's nearest hit (ops/intersect.py::
// nearest_hit_scene): there it takes the dots in the order of that
// renderer's intersect_block (xla_order, hit.cuh::dot3_xla), whose t = 0
// re-hits of a refracting face it must reproduce.
//
// Bound on an H100: instruction issue. Each ray-triangle test is ~51 FP32
// operations (two 3-term dots, a subtract and an IEEE divide for the
// plane, then per edge two dots and one multiply-add) against 24 bytes of
// ray read and 10 bytes written per ray, so at 42 triangles the work is
// ~2.1 kflop per 34 bytes, far above the card's ~20 flop/byte balance
// point; and the divide and the compares make a test more instructions
// than its flops count (chip_smoke.py reads the loop's instructions in the
// SASS).
// Design:
// - the [T, 16] pack is staged per block as four float4 rows a triangle
//   (hit.cuh::stage_tri_rows), so a triangle costs four 128-bit
//   shared-memory broadcasts (LDS.128), shared by the thread's rays; a
//   pack of more than kTile triangles streams through shared memory in
//   tiles of kTile, in order, so the strict < still keeps the lower index
//   on a tie;
// - kRays rays a thread, swept together: their tests of a triangle are
//   independent, so one ray's divide overlaps the others' arithmetic;
// - the triangle test in straight-line code (hit.cuh::tri_hit4);
// - no atomics: each thread writes its own rays' outputs, coalesced.
// A block of 128 threads takes 256 rays, and the grid covers the rays
// once: a persistent grid of as many blocks as fit on the card measured
// slower (its blocks loop unevenly), and this launch asks the driver
// nothing, so the host's part of a call stays small.

#include <cuda_runtime.h>

#include "hit.cuh"

namespace {

constexpr int kTriStride = 16;
constexpr int kBlock = 128;
constexpr int kRays = 2;
// triangles a tile: 64 bytes each in the 48 KB a launch gets without asking
// (ops/cuda/intersect_kernel.py::MAX_TRIS)
constexpr int kTile = 768;

// The sweep of one tile: triangles first .. first + count - 1 of the pack,
// whose rows start at `rows`, against the thread's kRays rays.
template <bool kXlaOrder>
__device__ __forceinline__ void sweep_tile(const float4* __restrict__ rows,
                                           int first, int count,
                                           const float* ox, const float* oy,
                                           const float* oz, const float* dx,
                                           const float* dy, const float* dz,
                                           NearestHit* h) {
  for (int t = 0; t < count; ++t) {
    const float4* r = rows + 4 * t;
    const float4 p = r[0], g0 = r[1], g1 = r[2], g2 = r[3];
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      float tt, nd;
      // strict < keeps the lower index on a tie, like the plain argmin
      if (tri_hit4<kXlaOrder>(p, g0, g1, g2, ox[k], oy[k], oz[k], dx[k], dy[k],
                              dz[k], tt, nd) &&
          tt < h[k].t) {
        h[k].t = tt;
        h[k].idx = first + t;
        h[k].hit = true;
        h[k].front = nd < 0.0f;
      }
    }
  }
}

// kTiled: the pack has more than kTile triangles. A separate instantiation,
// so that a pack of one tile runs the untiled sweep alone (a kernel holding
// both paths measured ~2% slower at 42 triangles).
template <bool kXlaOrder, bool kTiled>
__global__ void __launch_bounds__(kBlock)
    intersect_kernel(const float* __restrict__ tri_pack, int n_tris,
                     const float* __restrict__ o, const float* __restrict__ d,
                     int n, float* __restrict__ t_out, int* __restrict__ idx_out,
                     unsigned char* __restrict__ hit_out,
                     unsigned char* __restrict__ front_out) {
  extern __shared__ float4 s_rows[];
  // a pack of one tile is staged once, before the rays are read
  if (!kTiled) {
    stage_tri_rows(s_rows, tri_pack, n_tris, kTriStride);
    __syncthreads();
  }
  // ray k of this thread: first + k * blockDim.x + threadIdx.x; past the
  // end a lane sweeps the last ray again and stores nothing
  const int first = blockIdx.x * kRays * blockDim.x + threadIdx.x;
  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  NearestHit h[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int i = min(first + k * (int)blockDim.x, n - 1);
    ox[k] = o[3 * i];
    oy[k] = o[3 * i + 1];
    oz[k] = o[3 * i + 2];
    dx[k] = d[3 * i];
    dy[k] = d[3 * i + 1];
    dz[k] = d[3 * i + 2];
    h[k] = NearestHit{SPT_BIG, 0, false, false};
  }
  if (!kTiled) {
    sweep_tile<kXlaOrder>(s_rows, 0, n_tris, ox, oy, oz, dx, dy, dz, h);
  } else {
    // tiles in order: the strict < still keeps the lower index on a tie
    for (int base = 0; base < n_tris; base += kTile) {
      const int count = min(kTile, n_tris - base);
      if (base > 0) __syncthreads();  // every thread is done with the last tile
      stage_tri_rows(s_rows, tri_pack + (size_t)base * kTriStride, count,
                     kTriStride);
      __syncthreads();
      sweep_tile<kXlaOrder>(s_rows, base, count, ox, oy, oz, dx, dy, dz, h);
    }
  }
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int i = first + k * (int)blockDim.x;
    if (i < n) {
      t_out[i] = h[k].t;
      idx_out[i] = h[k].idx;
      hit_out[i] = h[k].hit ? 1 : 0;
      front_out[i] = h[k].front ? 1 : 0;
    }
  }
}

}  // namespace

// o, d: [n, 3] f32; tri_pack: [n_tris, 16] f32; outputs [n]. xla_order:
// the dots in dot3_xla's order. Launches on `stream` and returns its CUDA
// error (0 = launched).
extern "C" int intersect_launch(const float* tri_pack, int n_tris,
                                const float* o, const float* d, int n,
                                int xla_order, float* t_out, int* idx_out,
                                unsigned char* hit_out,
                                unsigned char* front_out, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = sizeof(float4) * 4 * (size_t)min(max(n_tris, 1), kTile);
  const int grid = (n + kRays * kBlock - 1) / (kRays * kBlock);
  const auto kernel =
      n_tris > kTile ? (xla_order ? intersect_kernel<true, true>
                                  : intersect_kernel<false, true>)
                     : (xla_order ? intersect_kernel<true, false>
                                  : intersect_kernel<false, false>);
  kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      tri_pack, n_tris, o, d, n, t_out, idx_out, hit_out, front_out);
  return (int)cudaGetLastError();
}
