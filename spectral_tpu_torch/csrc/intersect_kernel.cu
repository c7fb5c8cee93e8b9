// Dense ray-triangle nearest hit, one thread per ray.
//
// Replaces the TPU kernel spectral_tpu/ops/pallas/intersect_kernel.py
// :52 _intersect_kernel (launched by intersect_pallas :108). Its sweep is
// the nearest_hit function of hit.cuh, the same one the render megakernel
// runs per bounce.
//
// Bound on an H100: arithmetic. Each ray-triangle test is ~51 FP32
// operations (two 3-term dots, a subtract and a divide for the plane, then
// per edge two dots and one multiply-add) against 24 bytes of ray read and
// 13 bytes written per ray, so at 42 triangles the work is ~2.1 kflop per
// 37 bytes, far above the card's ~20 flop/byte balance point.
// Design: the packed table ([T, 16] floats, <= 48 KB) is staged in shared
// memory once per block and every read of it is a warp-wide broadcast; the
// ray lives in registers; no atomics, each thread writes its own outputs.
// Right and simple first: no tiling of the sweep, no early out.

#include <cuda_runtime.h>

#include "hit.cuh"

namespace {

constexpr int kTriStride = 16;
constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
    intersect_kernel(const float* __restrict__ tri_pack, int n_tris,
                     const float* __restrict__ o, const float* __restrict__ d,
                     int n, float* __restrict__ t_out, int* __restrict__ idx_out,
                     unsigned char* __restrict__ hit_out,
                     unsigned char* __restrict__ front_out) {
  extern __shared__ float s_tri[];
  stage(s_tri, tri_pack, n_tris * kTriStride);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const NearestHit h = nearest_hit<kTriStride>(
      s_tri, n_tris, o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
      d[3 * i + 1], d[3 * i + 2]);
  t_out[i] = h.t;
  idx_out[i] = h.idx;
  hit_out[i] = h.hit ? 1 : 0;
  front_out[i] = h.front ? 1 : 0;
}

}  // namespace

// o, d: [n, 3] f32; tri_pack: [n_tris, 16] f32; outputs [n]. Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int intersect_launch(const float* tri_pack, int n_tris,
                                const float* o, const float* d, int n,
                                float* t_out, int* idx_out,
                                unsigned char* hit_out,
                                unsigned char* front_out, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = sizeof(float) * (size_t)n_tris * kTriStride;
  const int grid = (n + kBlock - 1) / kBlock;
  intersect_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      tri_pack, n_tris, o, d, n, t_out, idx_out, hit_out, front_out);
  return (int)cudaGetLastError();
}
