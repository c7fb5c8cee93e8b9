// Dense nearest-hit sweeps shared by the intersect kernel and the render
// megakernel, and the triangle test the leaf sweep (leaf_sweep.cuh) shares.
//
// Threads test their rays against every triangle of a table held in shared
// memory. All threads of a warp read the same row at the same time, so
// each read is a shared-memory broadcast. The plane test is the
// reference's tri::hit (primitives/tri.cu:12-25); the interior test is its
// is_interior_faster (tri.cu:121-128) as three affine functionals >= 0.
//
// A triangle's 16 floats (normal n, plane offset, sign-folded edge
// functionals g_k and c_k, see models/geometry.py) arrive as a packed row
// (n 0:3, offset 3, g 4:13, c 13:16; the render pack adds the material id
// at column 16) and are restaged as four float4, (n, offset) and (g_k, c_k)
// for k = 0, 1, 2, by stage_tri_rows: a packed row of 16 or 17 floats is
// not a whole number of 16-byte rows, so read as it is a triangle would
// cost 16 shared-load instructions, and as float4 rows it costs 4 128-bit
// broadcasts (LDS.128). stage_rows also puts the render pack's material ids
// in a separate int array, read only on a hit. Every sweep runs tri_hit4,
// so all take the same operations in the same order.
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

// The same sum in the order of XLA's 3-term reduction or K = 3 matmul, the
// XLA-style renderer's intersect_block (ops/fp32.py::sum3):
// fma(a2, b2, fma(a1, b1, a0*b0))
__device__ __forceinline__ float dot3_xla(float a0, float a1, float a2,
                                          float b0, float b1, float b2) {
  return fmaf(a2, b2, fmaf(a1, b1, a0 * b0));
}

template <bool kXlaOrder>
__device__ __forceinline__ float dot3_in(float a0, float a1, float a2,
                                         float b0, float b1, float b2) {
  return kXlaOrder ? dot3_xla(a0, a1, a2, b0, b1, b2)
                   : dot3(a0, a1, a2, b0, b1, b2);
}

struct NearestHit {
  float t;     // distance to the nearest hit, SPT_BIG on a miss
  int idx;     // its triangle, 0 on a miss
  bool hit;
  bool front;  // the ray meets the triangle's front face (n . d < 0)
};

// The plane and interior tests of one triangle, given as (n, offset) and
// (g_k, c_k): whether the ray meets it at a distance tt >= 0 (tt and
// nd = n . d out). The tests combine with & rather than &&: every test is
// computed, in straight-line code, instead of a branch around each later
// one (the branches and their reconvergence points cost more instructions
// than the tests they skip). kXlaOrder takes the dots in dot3_xla's order
// (the XLA-style renderer's selection), else in dot3's (the kernels').
template <bool kXlaOrder = false>
__device__ __forceinline__ bool tri_hit4(float4 p, float4 g0, float4 g1,
                                         float4 g2, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float& tt, float& nd) {
  nd = dot3_in<kXlaOrder>(p.x, p.y, p.z, dx, dy, dz);
  const float no = dot3_in<kXlaOrder>(p.x, p.y, p.z, ox, oy, oz);
  tt = (p.w - no) / nd;
  bool inside = (fabsf(nd) >= SPT_DENOM_EPS) & (tt >= 0.0f);
  const float4 g[3] = {g0, g1, g2};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float ao = dot3_in<kXlaOrder>(g[k].x, g[k].y, g[k].z, ox, oy, oz) + g[k].w;
    const float ad = dot3_in<kXlaOrder>(g[k].x, g[k].y, g[k].z, dx, dy, dz);
    inside = inside & (fmaf(tt, ad, ao) >= 0.0f);
  }
  return inside;
}

// The nearest hit of one ray over the float4 rows of stage_tri_rows (4 per
// triangle).
__device__ __forceinline__ NearestHit nearest_hit_rows(
    const float4* __restrict__ rows, int n_tris, float ox, float oy, float oz,
    float dx, float dy, float dz) {
  NearestHit h{SPT_BIG, 0, false, false};
  for (int t = 0; t < n_tris; ++t) {
    const float4* r = rows + 4 * t;
    float tt, nd;
    // strict < keeps the lower index on a tie, like the plain argmin
    if (tri_hit4(r[0], r[1], r[2], r[3], ox, oy, oz, dx, dy, dz, tt, nd) &&
        tt < h.t) {
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

// Restage n_tris packed rows of width `stride` (>= 16) as the float4 rows
// of nearest_hit_rows, all threads of the block together.
__device__ __forceinline__ void stage_tri_rows(float4* __restrict__ rows,
                                               const float* __restrict__ src,
                                               int n_tris, int stride) {
  for (int k = threadIdx.x; k < 4 * n_tris; k += blockDim.x) {
    const float* p = src + (k >> 2) * stride;
    const int q = k & 3;
    rows[k] = q == 0 ? make_float4(p[0], p[1], p[2], p[3])
                     : make_float4(p[3 * q + 1], p[3 * q + 2], p[3 * q + 3],
                                   p[12 + q]);
  }
}

// stage_tri_rows of the render pack (stride >= 17, material id at column
// 16), and its material ids as ints.
__device__ __forceinline__ void stage_rows(float4* __restrict__ rows,
                                           int* __restrict__ mat_id,
                                           const float* __restrict__ src,
                                           int n_tris, int stride) {
  stage_tri_rows(rows, src, n_tris, stride);
  for (int t = threadIdx.x; t < n_tris; t += blockDim.x)
    mat_id[t] = (int)src[t * stride + 16];
}
