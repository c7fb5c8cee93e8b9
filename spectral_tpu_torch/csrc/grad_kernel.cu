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
// Work per (sample, ray), one thread each:
//   - the bounce residuals are read once: one pass builds the miss flag,
//     the set of materials present and each one's bounce count. With at
//     most 16 materials and 15 bounces (kPacked) the counts are nibbles of
//     one uint64_t in registers; otherwise a count and a presence bit per
//     material live in the thread's own shared-memory columns;
//   - the material terms: in the packed form without Sellmeier scalars the
//     warp's (lane, material) items are dealt over its 32 lanes, round by
//     round (a prefix sum of the lanes' item counts; the item's lane sends
//     its comb and contributions by shuffle), so a warp runs
//     ceil(items / 32) rounds, not its busiest lane's count; otherwise each
//     lane walks its own materials, ascending (sell_b is a per-lane sum).
//     Either way a warp never runs the union of its lanes' materials.
//
// Reduction, deterministic (no float atomics): each thread owns 4M float
// accumulators in shared memory, stored column-major ([4M][block], so
// lanes hit distinct banks whatever material each one adds to). The 95
// background knots are per warp, not per thread: each lane that missed
// stages its 7 (cell, weight at cell, weight at cell + 1) at its slot, its
// rank among the warp's missed lanes; then groups of 7 lanes (one per
// wavelength) add the slots into kGroups knot rows of the warp, group q
// taking slots q, q + kGroups, ... in order. Within one lane's comb the 14
// knots touched are distinct (the comb's wavelengths are 13.4 cells
// apart), so a group's 7 lanes never collide, and each group has its own
// row. At the end the block sums its columns in thread order and its knot
// rows in (warp, group) order into one row of partials [grid, R]; a second
// kernel sums each column over the rows in a fixed tree. Two launches on
// the same inputs give the same bits. The block size is the one of kBlocks
// with the most resident warps (the occupancy API, given the shared memory
// M needs), the grid the card's resident block count, capped by the ray
// count. The CIE and background tables are staged as float4 rows (x, y, z,
// background) per knot, so a wavelength's lookups are two 16-byte loads.
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

#include "spectrum.cuh"

namespace {

using namespace spt;

constexpr int kMaxBlock = 256;
constexpr int kMinBlocks = 4;  // 32 warps an SM at 256 threads: <= 64 registers
constexpr int kBlocks[] = {256, 128, 64, 32};
constexpr int kMatStride = 16;  // MAT_PACK_WIDTH
constexpr int kMatRow = 8;      // per material: c0, c1, c2, 1 - is_diel, is_emis, 2 / p
constexpr int kKnotRow = 97;    // 95 knots, padded to an odd stride
constexpr int kGroups = 3;      // knot rows a warp: 3 groups of 7 lanes
constexpr int kPackedMats = 16;
constexpr int kPackedBounces = 15;
constexpr int kReduceBlock = 256;

__device__ __forceinline__ float lut_slope(const float* row, int cell) {
  return row[cell + 1] - row[cell];
}

// lut of one channel of the float4 knot rows: t0 = row[cell], t1 = row[cell + 1]
__device__ __forceinline__ float lerp4(float t0, float t1, float frac) {
  return fmaf(1.0f - frac, t0, frac * t1);
}

// bit 4m set where nibble m of packed bounce counts is not 0
__device__ __forceinline__ uint64_t present_bits(uint64_t counts) {
  return (counts | counts >> 1 | counts >> 2 | counts >> 3) & 0x1111111111111111ull;
}

struct Layout {
  int mats, row, words;  // materials, R, presence words (unpacked form)
  int block;
  // offsets in floats from the start of shared memory: the float4 knot
  // rows (CIE x, y, z, background) at 0, then the D65 row, the materials,
  // the accumulator columns, the warps' knot rows and their staging
  // (per warp 32 x 7 weights at cell, at cell + 1, and the cells as bytes),
  // and the unpacked form's counts and presence words
  int d65, mat, acc, knot, v0, v1, cell, cnt, pres, total;
};

__host__ __device__ inline Layout layout(int n_mats, int block, bool bg,
                                         bool packed) {
  Layout l;
  l.mats = n_mats;
  l.row = 4 * n_mats + (bg ? kSamples : 0);
  l.words = (n_mats + 31) / 32;
  l.block = block;
  const int warps = block / 32;
  const int stage = bg ? warps * 32 * kW : 0;
  l.d65 = 4 * kSamples;
  l.mat = l.d65 + kSamples + 1;  // 16-byte aligned
  l.acc = l.mat + n_mats * kMatRow;
  l.knot = l.acc + 4 * n_mats * block;
  l.v0 = l.knot + (bg ? warps * kGroups * kKnotRow : 0);
  l.v1 = l.v0 + stage;
  l.cell = l.v1 + stage;
  l.cnt = l.cell + stage / 4;
  l.pres = l.cnt + (packed ? 0 : n_mats * block);
  l.total = l.pres + (packed ? 0 : l.words * block);
  return l;
}

template <bool kWantBg, bool kWantSell, bool kPacked>
__global__ void __launch_bounds__(kMaxBlock, kMinBlocks) replay_kernel(
    const float* __restrict__ mat_pack, int n_mats,
    const float* __restrict__ tables, const float* __restrict__ g,
    const float* __restrict__ hero_in, const float* __restrict__ nvalid_in,
    const float* __restrict__ power_in, const int* __restrict__ matres,
    int n, int spp, int bounces, float* __restrict__ partial,
    float* __restrict__ sell_a, float* __restrict__ sell_b) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout L = layout(n_mats, T, kWantBg, kPacked);
  const float4* s_tab = smem4;
  float* d65_row = smem + L.d65;
  float* s_mat = smem + L.mat;
  float* s_acc = smem + L.acc + tid;  // column k of this thread at k * T
  for (int c = tid; c < kSamples; c += T) {
    smem4[c] = make_float4(tables[kCieX * kSamples + c], tables[kCieY * kSamples + c],
                           tables[kCieZ * kSamples + c], tables[kBg * kSamples + c]);
    d65_row[c] = tables[kD65 * kSamples + c];
  }
  for (int m = tid; m < n_mats; m += T) {
    const float* mr = mat_pack + m * kMatStride;
    float* d = s_mat + m * kMatRow;
    d[0] = mr[0];
    d[1] = mr[1];
    d[2] = mr[2];
    d[3] = 1.0f - mr[5];
    d[4] = mr[6];
    d[5] = 2.0f / sqrtf(fmaxf(mr[8], 1e-30f));
  }
  for (int k = 0; k < 4 * n_mats; ++k) s_acc[k * T] = 0.0f;
  int* s_cnt = reinterpret_cast<int*>(smem + L.cnt) + tid;
  unsigned* s_pres = reinterpret_cast<unsigned*>(smem + L.pres) + tid;
  if constexpr (!kPacked) {
    for (int m = 0; m < n_mats; ++m) s_cnt[m * T] = 0;
    for (int q = 0; q < L.words; ++q) s_pres[q * T] = 0u;
  }
  float* s_knot = smem + L.knot + warp * kGroups * kKnotRow;
  float* s_v0 = smem + L.v0 + warp * 32 * kW;
  float* s_v1 = smem + L.v1 + warp * 32 * kW;
  uint8_t* s_cell = reinterpret_cast<uint8_t*>(smem + L.cell) + warp * 32 * kW;
  if constexpr (kWantBg) {
    for (int k = lane; k < kGroups * kKnotRow; k += 32) s_knot[k] = 0.0f;
  }
  __syncthreads();

  const float cscale = kCellScale;
  // this lane's share of the knot walk: group grp, wavelength wl
  const int grp = lane / kW, wl = lane - kW * grp;
  float* knot_row = s_knot + grp * kKnotRow;

  // base is uniform over the block, so every lane of a warp takes the same
  // iterations (the warp-wide knot walk needs them all)
  for (int base = blockIdx.x * T; base < n; base += gridDim.x * T) {
    const int i = base + tid;
    const bool live = i < n;
    float gx = 0.0f, gy = 0.0f, gz = 0.0f;
    if (live) {
      gx = g[3 * i];
      gy = g[3 * i + 1];
      gz = g[3 * i + 2];
    }
    for (int s = 0; s < spp; ++s) {
      const size_t si = (size_t)s * n + i;
      // one pass over the bounce residuals: miss flag, materials, counts
      uint64_t counts = 0;  // kPacked: nibble m = bounces on material m + 1
      bool missed = false;
      float hero = 0.0f, nv = 0.0f;
      if (live) {
        hero = hero_in[si];
        nv = nvalid_in[si];
        const int* mres = matres + (size_t)s * bounces * n + i;
        for (int b = 0; b < bounces; ++b) {
          const int mt = mres[(size_t)b * n];
          if (mt == -1) missed = true;
          if (mt > 0 && mt <= n_mats) {
            if constexpr (kPacked) {
              counts += 1ull << (4 * (mt - 1));
            } else {
              s_cnt[(mt - 1) * T] += 1;
              s_pres[((mt - 1) >> 5) * T] |= 1u << ((mt - 1) & 31);
            }
          }
        }
      }
      // the warp's missed lanes; this one's slot among them
      unsigned miss = 0;
      int slot = 0;
      if constexpr (kWantBg) {
        miss = __ballot_sync(0xffffffffu, missed);
        slot = __popc(miss & ((1u << lane) - 1u));
      }

      float lam[kW], a[kW], d65[kW], d65s[kW], tail[kW];
      const float fmissed = missed ? 1.0f : 0.0f;
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        int cell;
        float frac;
        comb_cell(hero, w, lam[w], cell, frac);
        const float4 t0 = s_tab[cell], t1 = s_tab[cell + 1];
        const float resp = gx * lerp4(t0.x, t1.x, frac) +
                           gy * lerp4(t0.y, t1.y, frac) +
                           gz * lerp4(t0.z, t1.z, frac);
        const float mask = (float)w < nv ? kDelta : 0.0f;
        const float p = live ? power_in[((size_t)s * kW + w) * n + i] : 0.0f;
        a[w] = resp * mask * p;
        if constexpr (kWantBg || kWantSell) {
          const float bgw = lerp4(t0.w, t1.w, frac);
          if constexpr (kWantBg) {
            if (missed) {
              const float common = a[w] * fmissed / fmaxf(bgw, 1e-30f);
              const int e = slot * kW + w;
              s_cell[e] = (uint8_t)cell;
              s_v0[e] = common * (1.0f - frac);
              s_v1[e] = common * frac;
            }
          }
          if constexpr (kWantSell) {
            d65[w] = lut(d65_row, cell, frac);
            d65s[w] = lut_slope(d65_row, cell) * cscale;
            const float respslope = (gx * (t1.x - t0.x) + gy * (t1.y - t0.y) +
                                     gz * (t1.z - t0.z)) *
                                    cscale;
            const float bgslope = (t1.w - t0.w) * cscale;
            tail[w] = mask * p * respslope +
                      a[w] * fmissed * bgslope / fmaxf(bgw, 1e-30f);
          }
        }
      }

      if constexpr (kWantBg) {
        if (miss) {
          __syncwarp();
          // the missed lanes' weights, slot by slot (ascending lanes): group
          // grp adds slots grp, grp + kGroups, ... at wavelength wl
          const int n_miss = __popc(miss);
          for (int first = 0; first < n_miss; first += kGroups) {
            const int e = (first + grp) * kW + wl;
            if (grp < kGroups && first + grp < n_miss) {
              const int cell = s_cell[e];
              knot_row[cell] += s_v0[e];
              knot_row[cell + 1] += s_v1[e];
            }
            __syncwarp();
          }
        }
      }

      float sellb = 0.0f;
      // the terms of material m at k bounces of the path with comb lam_ and
      // contributions a_, into this thread's accumulators
      auto material = [&](int m, int k, const float(&lam_)[kW], const float(&a_)[kW]) {
        const float k_m = (float)k;
        const float4 m0 = *reinterpret_cast<const float4*>(s_mat + m * kMatRow);
        const float4 m1 = *reinterpret_cast<const float4*>(s_mat + m * kMatRow + 4);
        const float c0 = m0.x, c1 = m0.y, c2 = m0.z;
        const float not_diel = m0.w, is_emis = m1.x, two_over_p = m1.y;
        float dc0 = 0.0f, dc1 = 0.0f, dc2 = 0.0f, dp = 0.0f;
#pragma unroll
        for (int w = 0; w < kW; ++w) {
          const float x = fmaf(fmaf(c0, lam_[w], c1), lam_[w], c2);
          const float inv_sq = 1.0f / fmaf(x, x, 1.0f);
          const float sq = sqrtf(inv_sq);
          const float sig = fmaf(0.5f * x, sq, 0.5f);
          const float dsig = 0.5f * inv_sq * sq;
          const float dlog_dx = not_diel * dsig / fmaxf(sig, 1e-30f);
          const float base = a_[w] * k_m;
          const float common = base * dlog_dx;
          dc0 += common * lam_[w] * lam_[w];
          dc1 += common * lam_[w];
          dc2 += common;
          dp += base * is_emis * two_over_p;
          if constexpr (kWantSell) {
            const float dxdlam = 2.0f * c0 * lam_[w] + c1;
            const float dlog_lam =
                dlog_dx * dxdlam + is_emis * (d65s[w] / fmaxf(d65[w], 1e-30f));
            sellb += base * dlog_lam;
          }
        }
        float* acc = s_acc + 4 * m * T;
        acc[0] += dc0;
        acc[T] += dc1;
        acc[2 * T] += dc2;
        acc[3 * T] += dp;
      };
      if constexpr (kPacked && !kWantSell) {
        // the warp's (lane, material) items, lanes ascending and each lane's
        // materials ascending, dealt round by round over its 32 lanes: a
        // warp runs ceil(items / 32) material iterations, not its busiest
        // lane's count. The item's lane sends its comb and contributions.
        const int n_items = __popcll(present_bits(counts));
        int start = n_items;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, start, d);
          if (lane >= d) start += v;
        }
        const int total = __shfl_sync(0xffffffffu, start, 31);
        start -= n_items;
        for (int first = 0; first < total; first += 32) {
          const int e = first + lane;
          int o = 0;  // the item's lane: the last one starting at or before e
#pragma unroll
          for (int step = 16; step; step >>= 1) {
            if (__shfl_sync(0xffffffffu, start, o + step) <= e) o += step;
          }
          const int j = e - __shfl_sync(0xffffffffu, start, o);
          const uint64_t counts_o =
              (uint64_t)__shfl_sync(0xffffffffu, (unsigned)(counts >> 32), o) << 32 |
              __shfl_sync(0xffffffffu, (unsigned)counts, o);
          float lam_o[kW], a_o[kW];
#pragma unroll
          for (int w = 0; w < kW; ++w) {
            lam_o[w] = __shfl_sync(0xffffffffu, lam[w], o);
            a_o[w] = __shfl_sync(0xffffffffu, a[w], o);
          }
          if (e < total) {
            uint64_t nz_o = present_bits(counts_o);
            for (int q = 0; q < j; ++q) nz_o &= nz_o - 1;
            const int m = (__ffsll((long long)nz_o) - 1) >> 2;
            material(m, (int)((counts_o >> (4 * m)) & 15ull), lam_o, a_o);
          }
        }
      } else if constexpr (kPacked) {
        // this lane's materials, ascending (the Sellmeier sum is per lane)
        for (uint64_t todo = counts; todo;) {
          const int m = (__ffsll((long long)todo) - 1) >> 2;
          material(m, (int)((todo >> (4 * m)) & 15ull), lam, a);
          todo &= ~(15ull << (4 * m));
        }
      } else if (live) {
        for (int q = 0; q < L.words; ++q) {
          unsigned bits = s_pres[q * T];
          s_pres[q * T] = 0u;
          for (; bits; bits &= bits - 1) {
            const int m = 32 * q + __ffs(bits) - 1;
            const int k = s_cnt[m * T];
            s_cnt[m * T] = 0;
            material(m, k, lam, a);
          }
        }
      }
      if constexpr (kWantSell) {
        if (live) {
          float sa = 0.0f;
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
  }

  __syncthreads();
  const float* acc_all = smem + L.acc;
  const float* knots = smem + L.knot;
  const int warps = T / 32;
  for (int c = tid; c < L.row; c += T) {
    float sum = 0.0f;
    if (c < 4 * n_mats) {
      for (int t = 0; t < T; ++t) sum += acc_all[c * T + t];
    } else {
      for (int r = 0; r < warps * kGroups; ++r)
        sum += knots[r * kKnotRow + c - 4 * n_mats];
    }
    partial[(size_t)blockIdx.x * L.row + c] = sum;
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

bool packed_form(int n_mats, int bounces) {
  return n_mats <= kPackedMats && bounces <= kPackedBounces;
}

// The launch shape: of kBlocks, the block size with the most resident
// warps an SM (ties to the larger block) for the shared memory M needs.
template <bool kWantBg, bool kWantSell, bool kPacked>
int shape_for(int n, int n_mats, int* shape) {
  auto kernel = replay_kernel<kWantBg, kWantSell, kPacked>;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return (int)e;
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
      cudaSuccess)
    return (int)e;
  int best_block = 0, best_per_sm = 0, best_smem = 0;
  for (int block : kBlocks) {
    const size_t smem = sizeof(float) * layout(n_mats, block, kWantBg, kPacked).total;
    if (smem > (size_t)optin) continue;
    int per_sm = 0;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, smem)) !=
        cudaSuccess)
      return (int)e;
    if (per_sm * block > best_per_sm * best_block) {
      best_block = block;
      best_per_sm = per_sm;
      best_smem = (int)smem;
    }
  }
  if (best_per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int need = (n + best_block - 1) / best_block;
  shape[0] = need < best_per_sm * sms ? need : best_per_sm * sms;
  shape[1] = best_block;
  shape[2] = best_per_sm;
  shape[3] = best_smem;
  shape[4] = kPacked;
  return 0;
}

template <bool kWantBg, bool kWantSell, bool kPacked>
int launch(const float* mat_pack, int n_mats, const float* tables,
           const float* g, const float* hero, const float* n_valid,
           const float* power, const int* matres, int n, int spp, int bounces,
           int grid, int block, float* partial, float* out, float* sell_a,
           float* sell_b, void* stream) {
  const Layout l = layout(n_mats, block, kWantBg, kPacked);
  replay_kernel<kWantBg, kWantSell, kPacked>
      <<<grid, block, sizeof(float) * l.total, (cudaStream_t)stream>>>(
          mat_pack, n_mats, tables, g, hero, n_valid, power, matres, n, spp,
          bounces, partial, sell_a, sell_b);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_kernel<<<l.row, kReduceBlock, 0, (cudaStream_t)stream>>>(partial, grid,
                                                                  l.row, out);
  return (int)cudaGetLastError();
}

template <bool kWantBg, bool kWantSell>
int shape_of(int n, int n_mats, int bounces, int* shape) {
  return packed_form(n_mats, bounces) ? shape_for<kWantBg, kWantSell, true>(n, n_mats, shape)
                                      : shape_for<kWantBg, kWantSell, false>(n, n_mats, shape);
}

template <bool kWantBg, bool kWantSell>
int launch_of(const float* mat_pack, int n_mats, const float* tables,
              const float* g, const float* hero, const float* n_valid,
              const float* power, const int* matres, int n, int spp,
              int bounces, int grid, int block, float* partial, float* out,
              float* sell_a, float* sell_b, void* stream) {
  auto fn = packed_form(n_mats, bounces) ? launch<kWantBg, kWantSell, true>
                                         : launch<kWantBg, kWantSell, false>;
  return fn(mat_pack, n_mats, tables, g, hero, n_valid, power, matres, n, spp,
            bounces, grid, block, partial, out, sell_a, sell_b, stream);
}

}  // namespace

// The launch shape of grad_launch for n rays, n_mats materials and
// `bounces` bounces: writes shape[0..4] = (grid, block, resident blocks an
// SM, dynamic shared bytes, 1 for the packed form) and returns 0, or
// returns a CUDA error code. Sets the kernel's shared-memory limit, so call
// it before grad_launch.
extern "C" int grad_grid(int n, int n_mats, int bounces, int want_bg,
                         int want_sell, int* shape) {
  if (want_bg)
    return want_sell ? shape_of<true, true>(n, n_mats, bounces, shape)
                     : shape_of<true, false>(n, n_mats, bounces, shape);
  return want_sell ? shape_of<false, true>(n, n_mats, bounces, shape)
                   : shape_of<false, false>(n, n_mats, bounces, shape);
}

// mat_pack [n_mats, 16], tables [5, 95], g [n, 3], hero / n_valid [spp, n]
// f32, power [spp, 7, n] f32, matres [spp, bounces, n] int32; partial
// [grid, R] f32 scratch, out [R] f32 with R = 4 * n_mats (+ 95 with
// want_bg): per material (dc0, dc1, dc2, d_power), then the background
// knots; sell_a / sell_b [spp, n] f32 with want_sell, else null; grid and
// block from grad_grid. Launches the replay and the column sum on
// `stream`; returns cudaGetLastError().
extern "C" int grad_launch(const float* mat_pack, int n_mats,
                           const float* tables, const float* g,
                           const float* hero, const float* n_valid,
                           const float* power, const int* matres, int n,
                           int spp, int bounces, int want_bg, int want_sell,
                           int grid, int block, float* partial, float* out,
                           float* sell_a, float* sell_b, void* stream) {
  auto fn = want_bg ? (want_sell ? launch_of<true, true> : launch_of<true, false>)
                    : (want_sell ? launch_of<false, true> : launch_of<false, false>);
  return fn(mat_pack, n_mats, tables, g, hero, n_valid, power, matres, n, spp,
            bounces, grid, block, partial, out, sell_a, sell_b, stream);
}
