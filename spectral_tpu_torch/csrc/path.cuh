// Path arithmetic shared by the megakernels (render_kernel.cu) and the
// sorted per-bounce kernels (wavefront_kernel.cu): the uniform draws, the
// camera ray, the hero wavelength's curves, one bounce's shading and
// scatter, and the XYZ tail. One source, so the two schedulers take the
// same float32 operations in the same order and give bit-equal paths.
//
// It follows the TPU kernel spectral_tpu/ops/pallas/render_kernel.py :1852
// _render_kernel and its helper _scatter_shade :1694 exactly: the SPD is
// the sigmoid-polynomial evaluated at lambda directly, material flags come
// from the pack (is_lamb = clip(1 - metal - diel - emis)), emitters use
// power^2, the Sellmeier index comes from the hero wavelength only, and
// n_valid, bounce-limit exhaustion and the EPSILON offset sign follow
// :1824-1832 and :2284. Products fuse into sums only through an explicit
// fmaf, where XLA's CPU backend contracts that kernel (ops/fp32.py); the
// sources are built with -fmad=false. ops/cuda/render_kernel.py writes the
// same operations in PyTorch (camera_rays, hero_curves, shade, path_xyz).
#pragma once

#include <stdint.h>

#include "hit.cuh"
#include "spectrum.cuh"

namespace spt {

constexpr int kTriStride = 17;  // TRI_PACK_WIDTH
constexpr int kMatStride = 16;  // MAT_PACK_WIDTH
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

// The stream key of pixel (px, py): hash32(seed ^ hash32(global index)).
__device__ __forceinline__ uint32_t pixel_key(uint32_t seed, float pxi,
                                              float pyi, int image_width) {
  const uint32_t pixel = (uint32_t)((int)pyi * image_width + (int)pxi);
  return hash32(seed ^ hash32(pixel));
}

// The uniform draws of one sample of one pixel. Draws, per sample: 0-1
// pixel jitter, 2 hero wavelength, 3+3b..5+3b bounce b (sphere z, sphere
// phi, reflect test), 3+3B and 4+3B the defocus disk. Either the column of
// injected planes rand[spp, 5+3B, n] (the JAX kernel's layout) or the hash
// of (chunk seed, global pixel, sample, draw) that
// ops/cuda/render_kernel.py::hash_uniforms writes identically.
struct Draws {
  const float* plane;  // &rand[s][0][p], or null for the hash
  int stride;          // n
  uint32_t key;        // hash32(pixel key + s * 0x85EBCA6B)

  __device__ __forceinline__ float operator()(int j) const {
    if (plane) return plane[(size_t)j * stride];
    return (float)(hash32(key + (uint32_t)j * 0x9E3779B9u) >> 8) * kInv24;
  }
};

__device__ __forceinline__ Draws sample_draws(const float* rand, int n, int p,
                                              int s, int n_draws,
                                              uint32_t key_pixel) {
  return Draws{rand ? rand + (size_t)s * n_draws * n + p : nullptr, n,
               hash32(key_pixel + (uint32_t)s * 0x85EBCA6Bu)};
}

struct Camera {
  float cx, cy, cz, p0x, p0y, p0z, dux, duy, duz, dvx, dvy, dvz;
  float ddux, dduy, dduz, ddvx, ddvy, ddvz, has_defocus;
};

__device__ __forceinline__ Camera load_camera(const float* __restrict__ cam) {
  return Camera{cam[0],  cam[1],  cam[2],  cam[3],  cam[4],  cam[5],  cam[6],
                cam[7],  cam[8],  cam[9],  cam[10], cam[11], cam[12], cam[13],
                cam[14], cam[15], cam[16], cam[17], cam[18]};
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// get_ray (rendering.cu:66-87) with the thin-lens disk
__device__ __forceinline__ Ray camera_ray(const Camera& c, float pxi,
                                          float pyi, const Draws& u,
                                          int bounces) {
  const float jx = u(0) - 0.5f;
  const float jy = u(1) - 0.5f;
  const float fx = pxi + jx;
  const float fy = pyi + jy;
  const float dr = sqrtf(u(3 + 3 * bounces)) * c.has_defocus;
  const float dth = kTwoPi * u(4 + 3 * bounces);
  const float du = dr * cosf(dth);
  const float dv = dr * sinf(dth);
  Ray r;
  r.ox = fmaf(dv, c.ddvx, fmaf(du, c.ddux, c.cx));
  r.oy = fmaf(dv, c.ddvy, fmaf(du, c.dduy, c.cy));
  r.oz = fmaf(dv, c.ddvz, fmaf(du, c.dduz, c.cz));
  r.dx = fmaf(fy, c.dvx, fmaf(fx, c.dux, c.p0x)) - r.ox;
  r.dy = fmaf(fy, c.dvy, fmaf(fx, c.duy, c.p0y)) - r.oy;
  r.dz = fmaf(fy, c.dvz, fmaf(fx, c.duz, c.p0z)) - r.oz;
  return r;
}

// spectrum.cu:31-48, fused as the megakernel's XLA form contracts it
__device__ __forceinline__ float hero_wavelength(float u) {
  return fmaf(kSpan, u, kLambdaMin);
}

// The hero comb, its table cells and the D65 and background weights.
struct Curves {
  float lam[kW], frac[kW], d65w[kW], bgw[kW];
  int cell[kW];
};

__device__ __forceinline__ void hero_curves(float hero,
                                            const float* __restrict__ tab,
                                            Curves& c) {
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    comb_cell(hero, w, c.lam[w], c.cell[w], c.frac[w]);
    c.d65w[w] = lut(tab + kD65 * kSamples, c.cell[w], c.frac[w]);
    c.bgw[w] = lut(tab + kBg * kSamples, c.cell[w], c.frac[w]);
  }
}

// A path's carried state: its ray, its power per wavelength, how many
// wavelengths are still valid, and whether it goes on.
struct Path {
  Ray r;
  float power[kW];
  float n_valid;
  bool alive;
};

__device__ __forceinline__ void start_path(Path& st, const Ray& r) {
  st.r = r;
#pragma unroll
  for (int w = 0; w < kW; ++w) st.power[w] = 1.0f;
  st.alive = true;
  st.n_valid = (float)kW;
}

// The hit triangle's normal and material id (zero on a miss).
struct Surface {
  float nx, ny, nz;
  int m;
};

// One bounce of a live path after its nearest hit (hit, front, t and the
// hit triangle's surface sf, read only on a hit): material fetch, spectral
// weight, scatter and termination (_scatter_shade). Returns the bounce's
// material residual: mat + 1 for a hit, -1 for a background miss.
__device__ __forceinline__ int shade(Path& st, bool hit, bool front, float t,
                                     const Surface& sf,
                                     const float* __restrict__ s_mat,
                                     const Curves& cv, float u_a, float u_b,
                                     float u_c) {
  const float ox = st.r.ox, oy = st.r.oy, oz = st.r.oz;
  const float dx = st.r.dx, dy = st.r.dy, dz = st.r.dz;
  const float hitf = hit ? 1.0f : 0.0f;
  const float missf = 1.0f - hitf;
  const float t_safe = hit ? t : 0.0f;
  const float hx = fmaf(t_safe, dx, ox);
  const float hy = fmaf(t_safe, dy, oy);
  const float hz = fmaf(t_safe, dz, oz);
  // normal flipped toward the ray; material 0 and a zero normal on a
  // miss, as the JAX sweep leaves them
  float nbx = 0.0f, nby = 0.0f, nbz = 0.0f;
  int m = 0;
  if (hit) {
    nbx = front ? sf.nx : -sf.nx;
    nby = front ? sf.ny : -sf.ny;
    nbz = front ? sf.nz : -sf.nz;
    m = sf.m;
  }
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
    const float x = fmaf(fmaf(c0, cv.lam[w], c1), cv.lam[w], c2);
    const float sig = 0.5f * x / sqrtf(fmaf(x, x, 1.0f)) + 0.5f;
    const float spd = is_diel + is_emis * power_sq * sig * cv.d65w[w] +
                      (is_lamb + is_metal) * sig;
    const float weight = hitf * spd + missf * cv.bgw[w] + 0.0f;
    new_power[w] = st.power[w] * weight;
  }

  // scatter directions
  const float ilen = 1.0f / sqrtf(dot3(dx, dy, dz, dx, dy, dz));
  const float ux = dx * ilen, uy = dy * ilen, uz = dz * ilen;
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
  const float hl = cv.lam[0] * 1e-3f;
  const float hero_um2 = hl * hl;
  const float n2 = 1.0f + b0 * hero_um2 / (hero_um2 - sc0) +
                   b1 * hero_um2 / (hero_um2 - sc1) +
                   b2 * hero_um2 / (hero_um2 - sc2);
  const float ir = sqrtf(fmaxf(n2, 1e-6f));
  const float ratio = front ? 1.0f / ir : ir;
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
  if (hit && refracted > 0.0f) st.n_valid = 1.0f;
  if (hit && is_metal > 0.0f && !metal_ok) st.n_valid = 0.0f;
  const float terminated = fmaxf(
      missf, hitf * fmaxf(is_emis, is_metal * (metal_ok ? 0.0f : 1.0f)));
  st.r.ox = fmaf(eps_sign * kEpsilon, nbx, hx);
  st.r.oy = fmaf(eps_sign * kEpsilon, nby, hy);
  st.r.oz = fmaf(eps_sign * kEpsilon, nbz, hz);
  if (terminated == 0.0f) {
    st.r.dx = ndx;
    st.r.dy = ndy;
    st.r.dz = ndz;
  }
#pragma unroll
  for (int w = 0; w < kW; ++w) st.power[w] = new_power[w];
  st.alive = terminated == 0.0f;
  return hit ? m + 1 : -1;
}

// XYZ of a finished path (dev_spectrum_to_XYZ, color.cu:88-104), with the
// bounce-limit rule already applied to n_valid (rendering.cu:38-39).
__device__ __forceinline__ void path_xyz(const float* power, float n_valid,
                                         const Curves& cv,
                                         const float* __restrict__ tab,
                                         float& sx, float& sy, float& sz) {
  sx = 0.0f;
  sy = 0.0f;
  sz = 0.0f;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const float contrib = power[w] * ((float)w < n_valid ? kDelta : 0.0f);
    sx = fmaf(contrib, lut(tab + kCieX * kSamples, cv.cell[w], cv.frac[w]), sx);
    sy = fmaf(contrib, lut(tab + kCieY * kSamples, cv.cell[w], cv.frac[w]), sy);
    sz = fmaf(contrib, lut(tab + kCieZ * kSamples, cv.cell[w], cv.frac[w]), sz);
  }
}

}  // namespace spt
