// Dense spectral path-tracing megakernel: one thread owns one pixel's whole
// path, over all samples and all bounces, in registers.
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
#include "spectrum.cuh"

namespace {

using namespace spt;

constexpr int kBlock = 128;
constexpr int kTriStride = 17;   // TRI_PACK_WIDTH
constexpr int kMatStride = 16;   // MAT_PACK_WIDTH
constexpr float kEpsilon = 1e-4f;
// python-double constant of the JAX kernel, rounded once to float
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979);
constexpr float kInv24 = 1.0f / 16777216.0f;

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

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

template <bool kSaveResiduals>
__global__ void __launch_bounds__(kBlock) render_kernel(
    const float* __restrict__ cam, uint32_t seed,
    const float* __restrict__ tri_pack, int n_tris,
    const float* __restrict__ mat_pack, int n_mats,
    const float* __restrict__ tables, const float* __restrict__ px,
    const float* __restrict__ py, int n, int image_width, int spp, int bounces,
    const float* __restrict__ rand, float* __restrict__ xyz,
    int* __restrict__ steps, Residuals res) {
  extern __shared__ float smem[];
  float* s_tri = smem;
  float* s_mat = s_tri + n_tris * kTriStride;
  float* s_tab = s_mat + n_mats * kMatStride;
  stage(s_tri, tri_pack, n_tris * kTriStride);
  stage(s_mat, mat_pack, n_mats * kMatStride);
  stage(s_tab, tables, 5 * kSamples);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const float cx = cam[0], cy = cam[1], cz = cam[2];
  const float p0x = cam[3], p0y = cam[4], p0z = cam[5];
  const float dux = cam[6], duy = cam[7], duz = cam[8];
  const float dvx = cam[9], dvy = cam[10], dvz = cam[11];
  const float ddux = cam[12], dduy = cam[13], dduz = cam[14];
  const float ddvx = cam[15], ddvy = cam[16], ddvz = cam[17];
  const float has_defocus = cam[18];

  const float pxi = px[i], pyi = py[i];
  const int n_draws = 5 + 3 * bounces;
  const uint32_t pixel = (uint32_t)((int)pyi * image_width + (int)pxi);
  const uint32_t key_pixel = hash32(seed ^ hash32(pixel));

  float accx = 0.0f, accy = 0.0f, accz = 0.0f;
  int live_steps = 0;

  for (int s = 0; s < spp; ++s) {
    const uint32_t key_sample = hash32(key_pixel + (uint32_t)s * 0x85EBCA6Bu);
    const float* plane = rand ? rand + (size_t)s * n_draws * n + i : nullptr;
    auto rnd = [&](int j) -> float {
      if (plane) return plane[(size_t)j * n];
      return (float)(hash32(key_sample + (uint32_t)j * 0x9E3779B9u) >> 8) * kInv24;
    };

    // camera ray (get_ray, rendering.cu:66-87) with the thin-lens disk
    const float jx = rnd(0) - 0.5f;
    const float jy = rnd(1) - 0.5f;
    const float fx = pxi + jx;
    const float fy = pyi + jy;
    const float dr = sqrtf(rnd(3 + 3 * bounces)) * has_defocus;
    const float dth = kTwoPi * rnd(4 + 3 * bounces);
    const float du = dr * cosf(dth);
    const float dv = dr * sinf(dth);
    float ox = fmaf(dv, ddvx, fmaf(du, ddux, cx));
    float oy = fmaf(dv, ddvy, fmaf(du, dduy, cy));
    float oz = fmaf(dv, ddvz, fmaf(du, dduz, cz));
    float dx = fmaf(fy, dvx, fmaf(fx, dux, p0x)) - ox;
    float dy = fmaf(fy, dvy, fmaf(fx, duy, p0y)) - oy;
    float dz = fmaf(fy, dvz, fmaf(fx, duz, p0z)) - oz;

    // hero wavelengths (spectrum.cu:31-48) and their table cells
    const float hero = fmaf(kSpan, rnd(2), kLambdaMin);
    const size_t si = (size_t)s * n + i;
    if constexpr (kSaveResiduals) res.hero[si] = hero;
    float lam[kW], frac[kW], d65w[kW], bgw[kW];
    int cell[kW];
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      comb_cell(hero, w, lam[w], cell[w], frac[w]);
      d65w[w] = lut(s_tab + kD65 * kSamples, cell[w], frac[w]);
      bgw[w] = lut(s_tab + kBg * kSamples, cell[w], frac[w]);
    }

    float power[kW];
#pragma unroll
    for (int w = 0; w < kW; ++w) power[w] = 1.0f;
    bool alive = true;
    float n_valid = (float)kW;

    int b = 0;
    for (; b < bounces && alive; ++b) {
      ++live_steps;
      const NearestHit h =
          nearest_hit<kTriStride>(s_tri, n_tris, ox, oy, oz, dx, dy, dz);
      const float hitf = h.hit ? 1.0f : 0.0f;
      const float missf = 1.0f - hitf;
      const float t_safe = h.hit ? h.t : 0.0f;
      const float hx = fmaf(t_safe, dx, ox);
      const float hy = fmaf(t_safe, dy, oy);
      const float hz = fmaf(t_safe, dz, oz);
      // normal flipped toward the ray; material 0 and a zero normal on a
      // miss, as the JAX sweep leaves them
      float nbx = 0.0f, nby = 0.0f, nbz = 0.0f;
      int m = 0;
      if (h.hit) {
        const float* tp = s_tri + h.idx * kTriStride;
        nbx = h.front ? tp[0] : -tp[0];
        nby = h.front ? tp[1] : -tp[1];
        nbz = h.front ? tp[2] : -tp[2];
        m = (int)tp[16];
      }
      if constexpr (kSaveResiduals)
        res.matres[((size_t)s * bounces + b) * n + i] = h.hit ? m + 1 : -1;
      const float* mr = s_mat + m * kMatStride;
      const float c0 = mr[0], c1 = mr[1], c2 = mr[2];
      const float is_lamb = mr[3], is_metal = mr[4], is_diel = mr[5],
                  is_emis = mr[6];
      const float fuzz = mr[7], power_sq = mr[8];
      const float b0 = mr[9], b1 = mr[10], b2 = mr[11];
      const float sc0 = mr[12], sc1 = mr[13], sc2 = mr[14];

      // spectral weight per wavelength (material.cuh:71-84)
      float new_power[kW];
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        const float x = fmaf(fmaf(c0, lam[w], c1), lam[w], c2);
        const float sig = 0.5f * x / sqrtf(fmaf(x, x, 1.0f)) + 0.5f;
        const float spd = is_diel + is_emis * power_sq * sig * d65w[w] +
                          (is_lamb + is_metal) * sig;
        const float weight = hitf * spd + missf * bgw[w] + 0.0f;
        new_power[w] = power[w] * weight;
      }

      // scatter directions
      const float ilen = 1.0f / sqrtf(dot3(dx, dy, dz, dx, dy, dz));
      const float ux = dx * ilen, uy = dy * ilen, uz = dz * ilen;
      const float u_a = rnd(3 + 3 * b), u_b = rnd(4 + 3 * b),
                  u_c = rnd(5 + 3 * b);
      const float sz = 2.0f * u_a - 1.0f;
      const float sphi = kTwoPi * u_b;
      const float sr = sqrtf(fmaxf(fmaf(-sz, sz, 1.0f), 0.0f));
      const float sx = sr * cosf(sphi);
      const float sy = sr * sinf(sphi);

      // lambertian (material.cu:8-19); degenerate -> normal
      float lx = nbx + sx, ly = nby + sy, lz = nbz + sz;
      if (fabsf(lx) < 1e-8f && fabsf(ly) < 1e-8f && fabsf(lz) < 1e-8f) {
        lx = nbx;
        ly = nby;
        lz = nbz;
      }

      // metallic (material.cu:22-37)
      const float dn = dot3(ux, uy, uz, nbx, nby, nbz);
      const float rx = fmaf(-(2.0f * dn), nbx, ux);
      const float ry = fmaf(-(2.0f * dn), nby, uy);
      const float rz = fmaf(-(2.0f * dn), nbz, uz);
      const float mx = fmaf(fuzz, sx, rx);
      const float my = fmaf(fuzz, sy, ry);
      const float mz = fmaf(fuzz, sz, rz);
      const bool metal_ok = dot3(mx, my, mz, nbx, nby, nbz) > 0.0f;

      // dielectric (material.cu:73-80, 102-136): Sellmeier n(hero)
      const float hl = lam[0] * 1e-3f;
      const float hero_um2 = hl * hl;
      const float n2 = 1.0f + b0 * hero_um2 / (hero_um2 - sc0) +
                       b1 * hero_um2 / (hero_um2 - sc1) +
                       b2 * hero_um2 / (hero_um2 - sc2);
      const float ir = sqrtf(fmaxf(n2, 1e-6f));
      const float ratio = h.front ? 1.0f / ir : ir;
      const float cos_t = fminf(-dn, 1.0f);
      const float sin_t = sqrtf(fmaxf(fmaf(-cos_t, cos_t, 1.0f), 0.0f));
      const float q = (1.0f - ratio) / (1.0f + ratio);
      const float r0 = q * q;
      const float om = 1.0f - cos_t;
      const float om2 = om * om;
      const float om5 = om * (om2 * om2);
      const float schlick = fmaf(1.0f - r0, om5, r0);
      const bool must_reflect = (ratio * sin_t > 1.0f) || (schlick > u_c);
      // refract (vec3.cuh:198-205)
      const float qx = ratio * fmaf(cos_t, nbx, ux);
      const float qy = ratio * fmaf(cos_t, nby, uy);
      const float qz = ratio * fmaf(cos_t, nbz, uz);
      const float par = sqrtf(fmaxf(1.0f - dot3(qx, qy, qz, qx, qy, qz), 0.0f));
      const float gx = must_reflect ? rx : fmaf(-par, nbx, qx);
      const float gy = must_reflect ? ry : fmaf(-par, nby, qy);
      const float gz = must_reflect ? rz : fmaf(-par, nbz, qz);
      const float refracted = is_diel * (must_reflect ? 0.0f : 1.0f);

      const float ndx = is_lamb * lx + is_metal * mx + is_diel * gx;
      const float ndy = is_lamb * ly + is_metal * my + is_diel * gy;
      const float ndz = is_lamb * lz + is_metal * mz + is_diel * gz;
      const float eps_sign = 1.0f - 2.0f * refracted;

      // wavelength bookkeeping + termination
      if (h.hit && refracted > 0.0f) n_valid = 1.0f;
      if (h.hit && is_metal > 0.0f && !metal_ok) n_valid = 0.0f;
      const float terminated = fmaxf(
          missf, hitf * fmaxf(is_emis, is_metal * (metal_ok ? 0.0f : 1.0f)));
      ox = fmaf(eps_sign * kEpsilon, nbx, hx);
      oy = fmaf(eps_sign * kEpsilon, nby, hy);
      oz = fmaf(eps_sign * kEpsilon, nbz, hz);
      if (terminated == 0.0f) {
        dx = ndx;
        dy = ndy;
        dz = ndz;
      }
#pragma unroll
      for (int w = 0; w < kW; ++w) power[w] = new_power[w];
      alive = terminated == 0.0f;
    }

    // bounce-limit exhaustion contributes nothing (rendering.cu:38-39)
    if (alive) n_valid = 0.0f;

    if constexpr (kSaveResiduals) {
      // the JAX kernel keeps an ended path frozen and records "none" for
      // each later bounce; the buffer is not zeroed beforehand
      for (; b < bounces; ++b) res.matres[((size_t)s * bounces + b) * n + i] = 0;
      res.n_valid[si] = n_valid;
#pragma unroll
      for (int w = 0; w < kW; ++w) res.power[((size_t)s * kW + w) * n + i] = power[w];
    }

    // XYZ integration (dev_spectrum_to_XYZ, color.cu:88-104)
    float sx_ = 0.0f, sy_ = 0.0f, sz_ = 0.0f;
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      const float contrib = power[w] * ((float)w < n_valid ? kDelta : 0.0f);
      sx_ = fmaf(contrib, lut(s_tab + kCieX * kSamples, cell[w], frac[w]), sx_);
      sy_ = fmaf(contrib, lut(s_tab + kCieY * kSamples, cell[w], frac[w]), sy_);
      sz_ = fmaf(contrib, lut(s_tab + kCieZ * kSamples, cell[w], frac[w]), sz_);
    }
    accx = accx + sx_;
    accy = accy + sy_;
    accz = accz + sz_;
  }

  xyz[3 * i] = accx;
  xyz[3 * i + 1] = accy;
  xyz[3 * i + 2] = accz;
  if (steps) steps[i] = live_steps;
}

template <bool kSaveResiduals>
int launch(const float* cam, uint32_t seed, const float* tri_pack, int n_tris,
           const float* mat_pack, int n_mats, const float* tables,
           const float* px, const float* py, int n, int image_width, int spp,
           int bounces, const float* rand, float* xyz, int* steps,
           Residuals res, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)n_tris * kTriStride +
                                       (size_t)n_mats * kMatStride +
                                       5 * kSamples);
  const int grid = (n + kBlock - 1) / kBlock;
  render_kernel<kSaveResiduals><<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      cam, seed, tri_pack, n_tris, mat_pack, n_mats, tables, px, py, n,
      image_width, spp, bounces, rand, xyz, steps, res);
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
  return launch<false>(cam, seed, tri_pack, n_tris, mat_pack, n_mats, tables,
                       px, py, n, image_width, spp, bounces, rand, xyz, steps,
                       Residuals{}, stream);
}

// render_launch's arguments plus the residual outputs: hero, n_valid
// [spp, n] f32, power [spp, 7, n] f32, matres [spp, bounces, n] int32.
extern "C" int render_residuals_launch(
    const float* cam, uint32_t seed, const float* tri_pack, int n_tris,
    const float* mat_pack, int n_mats, const float* tables, const float* px,
    const float* py, int n, int image_width, int spp, int bounces,
    const float* rand, float* xyz, int* steps, float* hero, float* n_valid,
    float* power, int* matres, void* stream) {
  return launch<true>(cam, seed, tri_pack, n_tris, mat_pack, n_mats, tables,
                      px, py, n, image_width, spp, bounces, rand, xyz, steps,
                      Residuals{hero, n_valid, power, matres}, stream);
}
