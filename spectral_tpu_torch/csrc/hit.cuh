// Dense nearest-hit sweep shared by the intersect kernel and the render
// megakernel, and the triangle test the leaf sweep (leaf_sweep.cuh) shares.
//
// One thread tests its ray against every triangle of a packed table held in
// shared memory (row stride STRIDE floats: normal 0:3, plane offset 3,
// sign-folded edge functionals g 4:13 and c 13:16, see models/geometry.py).
// All threads of a warp read the same row at the same time, so each read is
// a shared-memory broadcast. The plane test is the reference's tri::hit
// (primitives/tri.cu:12-25); the interior test is its is_interior_faster
// (tri.cu:121-128) as three affine functionals >= 0.
//
// Numerics: the sources are compiled with -fmad=false and without fast
// math, so every operation rounds once, in the written order, and products
// fuse into sums only where an explicit fmaf says so: where XLA's CPU
// backend contracts the JAX kernel's expressions (see ops/fp32.py). The
// plain PyTorch version (ops/intersect.py::nearest_hit) writes the same
// operations; the two take the same hit/miss decisions at grazing angles.
#pragma once

#define SPT_BIG 3.4e38f
#define SPT_DENOM_EPS 1e-8f

// a0*b0 + a1*b1 + a2*b2 contracted as XLA does: fma(a2, b2, fma(a0, b0, a1*b1))
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return fmaf(a2, b2, fmaf(a0, b0, a1 * b1));
}

struct NearestHit {
  float t;     // distance to the nearest hit, SPT_BIG on a miss
  int idx;     // its triangle, 0 on a miss
  bool hit;
  bool front;  // the ray meets the triangle's front face (n . d < 0)
};

// The plane and interior tests of one packed row p: whether the ray meets
// the triangle at a distance tt >= 0 (tt and nd = n . d out).
__device__ __forceinline__ bool tri_hit(const float* __restrict__ p, float ox,
                                        float oy, float oz, float dx, float dy,
                                        float dz, float& tt, float& nd) {
  nd = dot3(p[0], p[1], p[2], dx, dy, dz);
  const float no = dot3(p[0], p[1], p[2], ox, oy, oz);
  tt = (p[3] - no) / nd;
  bool inside = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* g = p + 4 + 3 * k;
    const float ao = dot3(g[0], g[1], g[2], ox, oy, oz) + p[13 + k];
    const float ad = dot3(g[0], g[1], g[2], dx, dy, dz);
    inside = inside && (fmaf(tt, ad, ao) >= 0.0f);
  }
  return inside && fabsf(nd) >= SPT_DENOM_EPS && tt >= 0.0f;
}

template <int STRIDE>
__device__ __forceinline__ NearestHit nearest_hit(
    const float* __restrict__ tri, int n_tris, float ox, float oy, float oz,
    float dx, float dy, float dz) {
  NearestHit h{SPT_BIG, 0, false, false};
  for (int t = 0; t < n_tris; ++t) {
    float tt, nd;
    // strict < keeps the lower index on a tie, like the plain argmin
    if (tri_hit(tri + t * STRIDE, ox, oy, oz, dx, dy, dz, tt, nd) && tt < h.t) {
      h.t = tt;
      h.idx = t;
      h.hit = true;
      h.front = nd < 0.0f;
    }
  }
  return h;
}

// Copy n floats from device memory into shared memory, all threads of the
// block together; the caller synchronises the block before reading.
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = src[k];
}
