// Residual replay: the fused backward of the render megakernel.
//
// Replaces the TPU kernel spectral_tpu/ops/pallas/grad_kernel.py :63
// _grad_kernel, launched by render_grads_pallas :289 (pallas_call :341).
// A path's XYZ is a product of per-bounce spectral weights, and material
// m's weight at a wavelength is the same at every bounce, so
//
//   d xyz / d theta_m = sum_{s,w} A_sw * k_m(s) * d log w_m(lambda_sw) / d theta_m
//
// with A_sw = (g . CIE)(lambda_sw) * mask_w * P_sw the cotangent-folded
// contribution (P the stored final power, mask_w = delta for w < n_valid)
// and k_m the number of bounces whose material residual is m + 1. No ray is
// traced again. Per (sample, ray) the thread rebuilds the wavelength comb
// from the stored hero with the forward's own arithmetic (spectrum.cuh), so
// every table cell equals the forward's, and accumulates:
//   - d(c0, c1, c2) and d(emission power) of each material it hit;
//   - with kWantBg, the background-SPD knot gradients: a miss (residual -1)
//     touches only knots cell and cell + 1 of each wavelength;
//   - with kWantSell, the per-(sample, ray) Sellmeier reparam scalars
//     sell_a = sum_w A_sw and sell_b = d A / d(comb shift) (:236-247).
// Terms are summed in the JAX kernel's order within a sample.
//
// Reduction, deterministic: each thread owns a row of 4M (+95) float
// accumulators in shared memory (an odd row stride, so the lanes of a warp
// hit distinct banks) and walks a fixed set of rays (grid-stride) and all
// samples in order. The block then sums its rows column by column, in
// thread order, into one row of partials [grid, R]; a second kernel sums
// each column over the rows in a fixed tree. No atomics: two launches on the
// same inputs give the same bits. The grid is the card's resident block
// count (occupancy API), capped by the ray count.
//
// Bound on an H100: it reads 4 * (2 + 7 + bounces) bytes per sample-ray
// plus 12 bytes of cotangent per ray. Counted from this source, an fmaf as
// two flops: ~189 flops per sample-ray (comb, three CIE lerps, the fold, the
// background lerp), 56 more where the path missed (two knot updates per
// wavelength), and ~203 per material present in the path (28 per
// wavelength); kWantSell adds ~189 per sample-ray and ~70 per material.
// At 68 bytes (8 bounces) against ~700 flops per sample-ray, the bytes bound
// it on this card (3.35 TB/s against 67 TFLOP/s). chip_smoke.py counts the
// materials present and the misses of its run for the bound.
//
// Numerics: -fmad=false; fmaf where the forward kernel fuses the same
// expression (the sigmoid polynomial, the lerp); ops/cuda/grad_kernel.py::
// render_grads_reference writes the same operations.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hit.cuh"
#include "spectrum.cuh"

namespace {

using namespace spt;

constexpr int kBlock = 64;
constexpr int kMatStride = 16;  // MAT_PACK_WIDTH
constexpr int kReduceBlock = 256;

__device__ __forceinline__ float lut_slope(const float* row, int cell) {
  return row[cell + 1] - row[cell];
}

template <bool kWantBg, bool kWantSell>
__global__ void __launch_bounds__(kBlock) replay_kernel(
    const float* __restrict__ mat_pack, int n_mats,
    const float* __restrict__ tables, const float* __restrict__ g,
    const float* __restrict__ hero_in, const float* __restrict__ nvalid_in,
    const float* __restrict__ power_in, const int* __restrict__ matres,
    int n, int spp, int bounces, int row, int row_stride,
    float* __restrict__ partial, float* __restrict__ sell_a,
    float* __restrict__ sell_b) {
  extern __shared__ float smem[];
  float* s_mat = smem;
  float* s_tab = s_mat + n_mats * kMatStride;
  float* s_acc = s_tab + 5 * kSamples;
  stage(s_mat, mat_pack, n_mats * kMatStride);
  stage(s_tab, tables, 5 * kSamples);
  float* acc = s_acc + threadIdx.x * row_stride;
  for (int k = 0; k < row; ++k) acc[k] = 0.0f;
  __syncthreads();

  const float* cie_x = s_tab + kCieX * kSamples;
  const float* cie_y = s_tab + kCieY * kSamples;
  const float* cie_z = s_tab + kCieZ * kSamples;
  const float* d65_row = s_tab + kD65 * kSamples;
  const float* bg_row = s_tab + kBg * kSamples;
  const float cscale = kCellScale;
  float* acc_bg = acc + 4 * n_mats;

  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float gx = g[3 * i], gy = g[3 * i + 1], gz = g[3 * i + 2];
    for (int s = 0; s < spp; ++s) {
      const size_t si = (size_t)s * n + i;
      const float hero = hero_in[si];
      const float nv = nvalid_in[si];

      // materials present in the path (bit m - 1), and the miss flag
      const int* mres = matres + (size_t)s * bounces * n + i;
      uint64_t present = 0;
      bool any_high = false;
      float missed = 0.0f;
      for (int b = 0; b < bounces; ++b) {
        const int mt = mres[(size_t)b * n];
        if (mt > 64) any_high = true;
        else if (mt > 0) present |= 1ull << (mt - 1);
        if (mt == -1) missed = 1.0f;
      }

      float lam[kW], a[kW], d65[kW], d65s[kW], tail[kW];
      float sa = 0.0f;
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        int cell;
        float frac;
        comb_cell(hero, w, lam[w], cell, frac);
        const float resp = gx * lut(cie_x, cell, frac) +
                           gy * lut(cie_y, cell, frac) +
                           gz * lut(cie_z, cell, frac);
        const float mask = (float)w < nv ? kDelta : 0.0f;
        const float p = power_in[((size_t)s * kW + w) * n + i];
        a[w] = resp * mask * p;
        if constexpr (kWantBg || kWantSell) {
          const float bgw = lut(bg_row, cell, frac);
          if constexpr (kWantBg) {
            if (missed != 0.0f) {
              const float common = a[w] * missed / fmaxf(bgw, 1e-30f);
              acc_bg[cell] += common * (1.0f - frac);
              acc_bg[cell + 1] += common * frac;
            }
          }
          if constexpr (kWantSell) {
            d65[w] = lut(d65_row, cell, frac);
            d65s[w] = lut_slope(d65_row, cell) * cscale;
            const float respslope = (gx * lut_slope(cie_x, cell) +
                                     gy * lut_slope(cie_y, cell) +
                                     gz * lut_slope(cie_z, cell)) *
                                    cscale;
            const float bgslope = lut_slope(bg_row, cell) * cscale;
            tail[w] = mask * p * respslope +
                      a[w] * missed * bgslope / fmaxf(bgw, 1e-30f);
          }
        }
      }

      float sellb = 0.0f;
      for (int m = 0; m < n_mats; ++m) {
        if (m < 64 ? !((present >> m) & 1ull) : !any_high) continue;
        int k = 0;
        for (int b = 0; b < bounces; ++b) k += mres[(size_t)b * n] == m + 1;
        if (k == 0) continue;
        const float k_m = (float)k;
        const float* mr = s_mat + m * kMatStride;
        const float c0 = mr[0], c1 = mr[1], c2 = mr[2];
        const float is_diel = mr[5], is_emis = mr[6], power_sq = mr[8];
        const float two_over_p = 2.0f / sqrtf(fmaxf(power_sq, 1e-30f));
        float dc0 = 0.0f, dc1 = 0.0f, dc2 = 0.0f, dp = 0.0f;
#pragma unroll
        for (int w = 0; w < kW; ++w) {
          const float x = fmaf(fmaf(c0, lam[w], c1), lam[w], c2);
          const float inv_sq = 1.0f / fmaf(x, x, 1.0f);
          const float sq = sqrtf(inv_sq);
          const float sig = fmaf(0.5f * x, sq, 0.5f);
          const float dsig = 0.5f * inv_sq * sq;
          const float dlog_dx = (1.0f - is_diel) * dsig / fmaxf(sig, 1e-30f);
          const float base = a[w] * k_m;
          const float common = base * dlog_dx;
          dc0 += common * lam[w] * lam[w];
          dc1 += common * lam[w];
          dc2 += common;
          dp += base * is_emis * two_over_p;
          if constexpr (kWantSell) {
            const float dxdlam = 2.0f * c0 * lam[w] + c1;
            const float dlog_lam =
                dlog_dx * dxdlam + is_emis * (d65s[w] / fmaxf(d65[w], 1e-30f));
            sellb += base * dlog_lam;
          }
        }
        acc[4 * m] += dc0;
        acc[4 * m + 1] += dc1;
        acc[4 * m + 2] += dc2;
        acc[4 * m + 3] += dp;
      }
      if constexpr (kWantSell) {
#pragma unroll
        for (int w = 0; w < kW; ++w) {
          sa += a[w];
          sellb += tail[w];
        }
        sell_a[si] = sa;
        sell_b[si] = sellb;
      }
    }
  }

  __syncthreads();
  for (int c = threadIdx.x; c < row; c += blockDim.x) {
    float sum = 0.0f;
    for (int t = 0; t < blockDim.x; ++t) sum += s_acc[t * row_stride + c];
    partial[(size_t)blockIdx.x * row + c] = sum;
  }
}

// out[c] = sum over the rows of partial[:, c], in a fixed order.
__global__ void __launch_bounds__(kReduceBlock) reduce_kernel(
    const float* __restrict__ partial, int rows, int row,
    float* __restrict__ out) {
  __shared__ float s_sum[kReduceBlock];
  const int c = blockIdx.x;
  float sum = 0.0f;
  for (int r = threadIdx.x; r < rows; r += kReduceBlock)
    sum += partial[(size_t)r * row + c];
  s_sum[threadIdx.x] = sum;
  __syncthreads();
  for (int h = kReduceBlock / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) s_sum[threadIdx.x] += s_sum[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[c] = s_sum[0];
}

int row_len(int n_mats, bool bg) { return 4 * n_mats + (bg ? kSamples : 0); }

size_t smem_bytes(int n_mats, int row) {
  return sizeof(float) * ((size_t)n_mats * kMatStride + 5 * kSamples +
                          (size_t)kBlock * (row | 1));
}

template <bool kWantBg, bool kWantSell>
int grid_for(int n, int n_mats, int* grid) {
  const int row = row_len(n_mats, kWantBg);
  const size_t smem = smem_bytes(n_mats, row);
  cudaError_t e = cudaFuncSetAttribute(
      replay_kernel<kWantBg, kWantSell>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, replay_kernel<kWantBg, kWantSell>, kBlock, smem)) != cudaSuccess)
    return (int)e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int need = (n + kBlock - 1) / kBlock;
  *grid = need < per_sm * sms ? need : per_sm * sms;
  return 0;
}

template <bool kWantBg, bool kWantSell>
int launch(const float* mat_pack, int n_mats, const float* tables,
           const float* g, const float* hero, const float* n_valid,
           const float* power, const int* matres, int n, int spp, int bounces,
           int grid, float* partial, float* out, float* sell_a, float* sell_b,
           void* stream) {
  const int row = row_len(n_mats, kWantBg);
  replay_kernel<kWantBg, kWantSell>
      <<<grid, kBlock, smem_bytes(n_mats, row), (cudaStream_t)stream>>>(
          mat_pack, n_mats, tables, g, hero, n_valid, power, matres, n, spp,
          bounces, row, row | 1, partial, sell_a, sell_b);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_kernel<<<row, kReduceBlock, 0, (cudaStream_t)stream>>>(partial, grid,
                                                                row, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows of partials grad_launch needs for n rays: writes it to *grid and
// returns 0, or returns a CUDA error code. Sets the kernel's shared-memory
// limit, so call it before grad_launch.
extern "C" int grad_grid(int n, int n_mats, int want_bg, int want_sell,
                         int* grid) {
  if (want_bg)
    return want_sell ? grid_for<true, true>(n, n_mats, grid)
                     : grid_for<true, false>(n, n_mats, grid);
  return want_sell ? grid_for<false, true>(n, n_mats, grid)
                   : grid_for<false, false>(n, n_mats, grid);
}

// mat_pack [n_mats, 16], tables [5, 95], g [n, 3], hero / n_valid [spp, n]
// f32, power [spp, 7, n] f32, matres [spp, bounces, n] int32; partial
// [grid, R] f32 scratch, out [R] f32 with R = 4 * n_mats (+ 95 with
// want_bg): per material (dc0, dc1, dc2, d_power), then the background
// knots; sell_a / sell_b [spp, n] f32 with want_sell, else null. Launches
// the replay and the column sum on `stream`; returns cudaGetLastError().
extern "C" int grad_launch(const float* mat_pack, int n_mats,
                           const float* tables, const float* g,
                           const float* hero, const float* n_valid,
                           const float* power, const int* matres, int n,
                           int spp, int bounces, int want_bg, int want_sell,
                           int grid, float* partial, float* out, float* sell_a,
                           float* sell_b, void* stream) {
  if (want_bg)
    return want_sell
               ? launch<true, true>(mat_pack, n_mats, tables, g, hero, n_valid,
                                    power, matres, n, spp, bounces, grid,
                                    partial, out, sell_a, sell_b, stream)
               : launch<true, false>(mat_pack, n_mats, tables, g, hero,
                                     n_valid, power, matres, n, spp, bounces,
                                     grid, partial, out, sell_a, sell_b,
                                     stream);
  return want_sell
             ? launch<false, true>(mat_pack, n_mats, tables, g, hero, n_valid,
                                   power, matres, n, spp, bounces, grid,
                                   partial, out, sell_a, sell_b, stream)
             : launch<false, false>(mat_pack, n_mats, tables, g, hero, n_valid,
                                    power, matres, n, spp, bounces, grid,
                                    partial, out, sell_a, sell_b, stream);
}
