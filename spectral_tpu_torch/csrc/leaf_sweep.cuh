// Nearest hit over Morton-ordered leaves, one ray per thread: the sweep
// shared by the leaf megakernel (render_kernel.cu, kLeaves) and the sorted
// per-bounce kernels (wavefront_kernel.cu).
//
// Replaces the nearest-hit part of the TPU leaf sweep,
// spectral_tpu/ops/pallas/render_kernel.py :565 _mxu_leaf_sweep, without
// its MXU score forms: each triangle gets the same exact float32 test as
// the dense sweep (hit.cuh::tri_hit). The leaf cull is that kernel's
// _slab_want (:701-724) op for op: slab test against the leaf AABB with
// the +-1e-20 safe reciprocal (:664-670), enter = max(tmin, 0), and the
// leaf is entered when tmax >= enter and enter < best_t. A padded leaf's
// inverted AABB passes that test, so the valid flag (column 6) is checked
// first.
//
// Layout (ops/cuda/render_kernel.py::pack_scene_leaves): tri [NL * K, 18]
// = the dense row (normal, plane offset, edge functionals, material) and
// the triangle's original index at column 17, zero rows as padding; leaf
// [NL, 8] = AABB min xyz, max xyz, valid flag, spare. Both stay in device
// memory: every lane of a warp that enters a leaf reads the same row at
// the same time, a broadcast served by L1/L2 (the 10k-triangle pack is
// 720 KB, the 200k one 14.4 MB, inside the 50 MB L2). A lane enters only
// the leaves it wants; the warp runs a leaf's triangle loop when any of
// its lanes does, the others idle.
//
// Selection: the lexicographic minimum of (t, original index) over the
// triangles tested, so a tie goes to the lower original index and the
// result equals the dense sweep's over the unsorted scene whatever the leaf
// size or order (ops/intersect.py::nearest_hit_leaves is the plain
// version).
#pragma once

#include "hit.cuh"

constexpr int kLeafTriStride = 18;  // LEAF_TRI_WIDTH
constexpr int kLeafStride = 8;      // LEAF_PACK_WIDTH

struct LeafHit {
  float t;    // distance to the nearest hit, SPT_BIG on a miss
  int row;    // its row in the leaf pack, 0 on a miss
  int idx;    // its original triangle index (valid when hit)
  bool hit;
  bool front;  // the ray meets the triangle's front face (n . d < 0)
};

// 1 / x with |x| raised to at least 1e-20 and its sign kept (-0 counts as
// positive), as render_kernel.py:664-670.
__device__ __forceinline__ float safe_inv(float x) {
  const float safe = x >= 0.0f ? fmaxf(x, 1e-20f) : fminf(x, -1e-20f);
  return 1.0f / safe;
}

// `visits` is incremented once per leaf entered.
__device__ __forceinline__ LeafHit nearest_hit_leaves(
    const float* __restrict__ tri, const float* __restrict__ leaf,
    int n_leaves, int leaf_size, float ox, float oy, float oz, float dx,
    float dy, float dz, int& visits) {
  LeafHit h{SPT_BIG, 0, 0, false, false};
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  for (int l = 0; l < n_leaves; ++l) {
    const float* lf = leaf + (size_t)l * kLeafStride;
    if (__ldg(lf + 6) == 0.0f) continue;
    float t1 = (__ldg(lf + 0) - ox) * ix;
    float t2 = (__ldg(lf + 3) - ox) * ix;
    float tmin = fminf(t1, t2), tmax = fmaxf(t1, t2);
    t1 = (__ldg(lf + 1) - oy) * iy;
    t2 = (__ldg(lf + 4) - oy) * iy;
    tmin = fmaxf(tmin, fminf(t1, t2));
    tmax = fminf(tmax, fmaxf(t1, t2));
    t1 = (__ldg(lf + 2) - oz) * iz;
    t2 = (__ldg(lf + 5) - oz) * iz;
    tmin = fmaxf(tmin, fminf(t1, t2));
    tmax = fminf(tmax, fmaxf(t1, t2));
    const float enter = fmaxf(tmin, 0.0f);
    if (!(tmax >= enter && enter < h.t)) continue;
    ++visits;
    const int r0 = l * leaf_size;
    for (int k = 0; k < leaf_size; ++k) {
      const float* p = tri + (size_t)(r0 + k) * kLeafTriStride;
      float tt, nd;
      if (!tri_hit(p, ox, oy, oz, dx, dy, dz, tt, nd)) continue;
      const int idx = (int)__ldg(p + 17);
      if (tt < h.t || (h.hit && tt == h.t && idx < h.idx)) {
        h.t = tt;
        h.row = r0 + k;
        h.idx = idx;
        h.hit = true;
        h.front = nd < 0.0f;
      }
    }
  }
  return h;
}
