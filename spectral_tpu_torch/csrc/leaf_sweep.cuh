// Nearest hit over Morton-ordered leaves under a two-level hierarchy of
// leaf groups, one ray per thread: the sweep shared by the leaf megakernel
// (render_kernel.cu, kLeaves) and the sorted per-bounce kernels
// (wavefront_kernel.cu).
//
// Replaces the nearest-hit part of the TPU leaf sweep,
// spectral_tpu/ops/pallas/render_kernel.py :565 _mxu_leaf_sweep, without
// its MXU score forms: each triangle gets the same exact float32 test as
// the dense sweep (hit.cuh::tri_hit4). The cull is that kernel's: its leaf
// gate _slab_want (:701-724) op for op, a slab test against the AABB with
// the +-1e-20 safe reciprocal (:664-670), enter = max(tmin, 0), and the box
// is entered when tmax >= enter and enter < best_t; a padded box's inverted
// AABB passes that test, so its valid flag keeps it out. Above the
// leaves it keeps the JAX kernel's two gates (:1470-1660, MXU_GROUP8 and
// MXU_GROUP_L2, on by default): every GROUP_SIZE consecutive leaves form a
// group and every SUPER_SIZE consecutive groups a super-group, each with the
// union AABB of its valid members and an any-valid flag (tables built as
// :2921-2958 builds them, ops/intersect.py::leaf_groups). The sweep walks
// the super-groups in storage order, enters a super-group's groups only
// when its own test passes against the ray's best t, and a group's leaves
// only when the group's test passes.
//
// Built for a CUDA thread, not a TPU tile. The TPU kernel tests a box for a
// tile of rays and runs its members when any ray wants them
// (pl.when(max(want) > 0)); the same form here, a warp running a box's
// loop when any lane enters it, measured slower (PERF.md). Here each lane
// walks its own boxes: the slab tests of a box's kFan children are done
// together, their loads issued at once (chains of dependent loads are the
// likely bound of this loop), and the lane then takes the children whose test
// passed in order, each checked at its turn against the lane's best t
// (the same test as the flat sweep's, split in two). In nearest_hit_leaves
// (the leaf megakernel's form) the lanes of a warp walk their own lists
// side by side, so a warp's work is its busiest lane's, and its lanes run
// their boxes and leaves in passes of their own. The sorted kernels take
// the walk in resumable form (LeafWalk, below): a lane whose ray is done
// takes another, and a leaf is tested by several lanes together. The
// triangle loop is unrolled by 4 to keep four triangles' loads in flight.
//
// Exact, not a heuristic. A group's box contains each member's box, and
// (b - o) * inv rounds monotonically in b (a subtraction, then a product by
// the same reciprocal), so on each axis the group's slab interval contains
// the member's, and so do the [max(tmin, 0), tmax] intervals after the
// min/max over axes. A leaf that passes (tmax >= enter, enter < best_t)
// therefore has its group pass with the same best_t, and the best_t a
// group meets is never smaller than the one its leaves meet later. So the
// leaves entered, and their order, equal the flat sweep's over the same
// pack, and so does the hit. The same holds between super-groups and
// groups.
//
// Layout (ops/cuda/render_kernel.py::leaf_tables, built once per render
// call from the leaf pack of pack_scene_leaves): each triangle as four
// float4, (n, offset) and (g_k, c_k) for k = 0, 1, 2, the layout of
// hit.cuh::stage_rows, read with 128-bit loads (a row of the 18-float leaf
// pack is never 16-byte aligned); an int2 per triangle, (material id,
// original index), read on a hit; leaf, group and super-group rows of 8
// floats (min xyz, max xyz, valid flag, spare), read as two float4. The
// super-group table (196 rows, 6 KB, on the 200k-triangle field) is staged
// in shared memory by each block; groups (50 KB) and leaves (400 KB) come
// through L1 and L2 with __ldg. Staging the group table as well, groups of
// 16 leaves, super-groups of 16 groups and a third level measured no
// faster (PERF.md).
//
// Selection: the lexicographic minimum of (t, original index) over the
// triangles tested, so a tie goes to the lower original index and the
// result equals the dense sweep's over the unsorted scene whatever the leaf
// size or order (ops/intersect.py::nearest_hit_leaves is the plain
// version).
//
// Bound on an H100: FP32 arithmetic, counted from a run's counters:
// ~25 flops a slab test, for every valid super-group, the groups of each
// super-group entered and the leaves of each group entered, then 51 flops a
// triangle of each leaf entered. The loop is one of dependent loads and
// branches, so it runs far below that bound; what the hierarchy removes is
// most of the slab tests of the flat sweep (one per valid leaf a
// ray-step). In the sorted bounce kernels, whose lanes stay busy, about
// half of a launch on the 200k field is the tail: the rays still walking
// once every column is taken (PERF.md).
#pragma once

#include "hit.cuh"
#include "path.cuh"

// The leaf pack and the tables the sweep reads besides.
struct LeafScene {
  const float4* rows;   // [n_leaves * leaf_size * 4]
  const int2* ids;      // [n_leaves * leaf_size]: (material id, original index)
  const float4* leaf;   // [n_leaves * 2]
  const float4* group;  // [n_groups * 2]
  const float4* top;    // [n_tops * 2], the super-groups
  int n_leaves, leaf_size, n_groups, n_tops;
};

// Children of a box: leaves a group, groups a super-group
// (ops/intersect.py::GROUP_SIZE and SUPER_SIZE).
constexpr int kFan = 8;

// Boxes entered by one ray's sweeps, by level.
struct SweepCount {
  int leaves = 0, groups = 0, tops = 0;
};

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

// Bytes of shared memory for the super-group table (stage_tops).
__host__ __device__ __forceinline__ size_t top_smem(const LeafScene& sc) {
  return 2 * sizeof(float4) * (size_t)sc.n_tops;
}

// Copy the super-group table into shared memory, all threads of the block
// together; the caller synchronises the block before reading.
__device__ __forceinline__ void stage_tops(float4* __restrict__ s_top,
                                           const LeafScene& sc) {
  for (int k = threadIdx.x; k < 2 * sc.n_tops; k += blockDim.x)
    s_top[k] = __ldg(sc.top + k);
}

// The slab test of the box of rows a = (min xyz, max x), b = (max yz,
// valid, spare), op for op as _slab_want: whether the box is valid and the
// ray's slab interval passes (tmax >= enter), and `enter`, the entry
// distance. The ray enters the box when it passes and enter < best_t.
__device__ __forceinline__ bool box_slab(float4 a, float4 b, float ox,
                                         float oy, float oz, float ix,
                                         float iy, float iz, float& enter) {
  float t1 = (a.x - ox) * ix;
  float t2 = (a.w - ox) * ix;
  float tmin = fminf(t1, t2), tmax = fmaxf(t1, t2);
  t1 = (a.y - oy) * iy;
  t2 = (b.x - oy) * iy;
  tmin = fmaxf(tmin, fminf(t1, t2));
  tmax = fminf(tmax, fmaxf(t1, t2));
  t1 = (a.z - oz) * iz;
  t2 = (b.y - oz) * iz;
  tmin = fmaxf(tmin, fminf(t1, t2));
  tmax = fminf(tmax, fmaxf(t1, t2));
  enter = fmaxf(tmin, 0.0f);
  return b.z != 0.0f && tmax >= enter;
}

// The slab tests of n <= kFan consecutive boxes: bit j of `pass` is box j's
// box_slab, enter[j] its entry distance.
struct Slabs {
  unsigned pass;
  float enter[kFan];

  // enter[j] for a j known only at run time, kept out of local memory
  __device__ __forceinline__ float at(int j) const {
    float e = enter[0];
#pragma unroll
    for (int k = 1; k < kFan; ++k) e = j == k ? enter[k] : e;
    return e;
  }
};

// The Slabs of boxes first .. first + n - 1 of a table, all their loads
// issued before the tests: plain loads with kShared (a table in shared
// memory, or a generic pointer to either), else __ldg from device memory.
template <bool kShared>
__device__ __forceinline__ Slabs slabs(const float4* __restrict__ table,
                                       int first, int n, float ox, float oy,
                                       float oz, float ix, float iy,
                                       float iz) {
  Slabs r;
  r.pass = 0;
#pragma unroll
  for (int j = 0; j < kFan; ++j) {
    r.enter[j] = 0.0f;
    if (j < n) {
      const float4* p = table + 2 * (first + j);
      const float4 a = kShared ? p[0] : __ldg(p);
      const float4 b = kShared ? p[1] : __ldg(p + 1);
      if (box_slab(a, b, ox, oy, oz, ix, iy, iz, r.enter[j])) r.pass |= 1u << j;
    }
  }
  return r;
}

// The hit triangle's normal and material id.
__device__ __forceinline__ spt::Surface leaf_surface(const LeafScene& sc,
                                                     int row) {
  const float4 n = __ldg(sc.rows + 4 * (size_t)row);
  return spt::Surface{n.x, n.y, n.z, __ldg(&sc.ids[row].x)};
}

// Test the leaf_size triangles from row r0 and keep the nearest hit.
__device__ __forceinline__ void leaf_hits(const LeafScene& sc, int r0,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          LeafHit& h) {
#pragma unroll 4
  for (int k = 0; k < sc.leaf_size; ++k) {
    const float4* p = sc.rows + 4 * (size_t)(r0 + k);
    float tt, nd;
    if (!tri_hit4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3), ox, oy,
                  oz, dx, dy, dz, tt, nd))
      continue;
    const int idx = __ldg(&sc.ids[r0 + k].y);
    if (tt < h.t || (h.hit && tt == h.t && idx < h.idx)) {
      h.t = tt;
      h.row = r0 + k;
      h.idx = idx;
      h.hit = true;
      h.front = nd < 0.0f;
    }
  }
}

// The nearest hit of one ray; `cnt` is incremented once per box entered.
// Each loop takes the set bits of a Slabs in ascending order, so the boxes
// are visited in storage order, each entered when its entry lies nearer
// than the best hit at its turn.
__device__ __forceinline__ LeafHit nearest_hit_leaves(
    const LeafScene& sc, const float4* __restrict__ s_top, float ox,
    float oy, float oz, float dx, float dy, float dz, SweepCount& cnt) {
  LeafHit h{SPT_BIG, 0, 0, false, false};
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  for (int s0 = 0; s0 < sc.n_tops; s0 += kFan) {
    const Slabs ts = slabs<true>(s_top, s0, min(kFan, sc.n_tops - s0), ox,
                                 oy, oz, ix, iy, iz);
    for (unsigned mt = ts.pass; mt; mt &= mt - 1) {
      const int t = __ffs(mt) - 1;
      if (!(ts.at(t) < h.t)) continue;
      ++cnt.tops;
      const int g0 = (s0 + t) * kFan;
      const Slabs gs = slabs<false>(sc.group, g0, min(kFan, sc.n_groups - g0),
                                    ox, oy, oz, ix, iy, iz);
      for (unsigned mg = gs.pass; mg; mg &= mg - 1) {
        const int g = __ffs(mg) - 1;
        if (!(gs.at(g) < h.t)) continue;
        ++cnt.groups;
        const int l0 = (g0 + g) * kFan;
        const Slabs ls = slabs<false>(sc.leaf, l0, min(kFan, sc.n_leaves - l0),
                                      ox, oy, oz, ix, iy, iz);
        for (unsigned ml = ls.pass; ml; ml &= ml - 1) {
          const int l = __ffs(ml) - 1;
          if (!(ls.at(l) < h.t)) continue;
          ++cnt.leaves;
          leaf_hits(sc, (l0 + l) * sc.leaf_size, ox, oy, oz, dx, dy, dz, h);
        }
      }
    }
  }
  return h;
}

// The same walk in resumable form (wavefront_kernel.cu's persistent
// kernels, whose lanes interleave rays): its state lives in registers, and
// walk_boxes, walk_boxes_together or walk_leaves advance it by one unit, a
// batch of up to kFan box tests at one level or one leaf's triangles.
// walk_next chooses the next unit as nearest_hit_leaves's loops reach it:
// the children of the deepest batch still to take first, each entered when
// its entry lies nearer than the best hit at its turn, then the next
// super-group batch. So a walk enters the same boxes in the same order,
// with the same tests and counts, and ends with the same hit; only what a
// lane does between its units changes.
enum : int { kUnitEnd = 0, kUnitBoxes = 1, kUnitLeaf = 2 };

struct LeafWalk {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  LeafHit h;
  Slabs ts, gs, ls;  // the batch of each level: children still to take
  int s0, g0, l0;    // the first box of each level's batch
  int unit;          // the next unit (kUnitEnd once the walk is over)
  int level;         // of kUnitBoxes: 0 super-groups, 1 groups, 2 leaves
  int first;         // its first box, or kUnitLeaf's first triangle row
  SweepCount cnt;    // boxes entered
};

// the children of a batch still to take whose entry lies nearer than t
__device__ __forceinline__ unsigned nearer_children(const Slabs& s, float t) {
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < kFan; ++j) m |= (s.enter[j] < t ? 1u : 0u) << j;
  return s.pass & m;
}

// Choose the walk's next unit (kUnitEnd when there is none). The best hit
// does not change while the children are taken, so the children of a batch
// whose entry is not nearer, up to the first that is, are dropped at once,
// as the loops drop them one by one; walk_next has no loop, so no lane
// loops alone between the warp's shuffles and votes.
__device__ __forceinline__ void walk_next(const LeafScene& sc, LeafWalk& w) {
  const unsigned ml = nearer_children(w.ls, w.h.t);
  if (ml) {
    const int l = __ffs(ml) - 1;
    w.ls.pass &= ~((2u << l) - 1u);
    ++w.cnt.leaves;
    w.unit = kUnitLeaf;
    w.first = (w.l0 + l) * sc.leaf_size;
    return;
  }
  w.ls.pass = 0;
  const unsigned mg = nearer_children(w.gs, w.h.t);
  if (mg) {
    const int g = __ffs(mg) - 1;
    w.gs.pass &= ~((2u << g) - 1u);
    ++w.cnt.groups;
    w.l0 = (w.g0 + g) * kFan;
    w.unit = kUnitBoxes;
    w.level = 2;
    w.first = w.l0;
    return;
  }
  w.gs.pass = 0;
  const unsigned mt = nearer_children(w.ts, w.h.t);
  if (mt) {
    const int t = __ffs(mt) - 1;
    w.ts.pass &= ~((2u << t) - 1u);
    ++w.cnt.tops;
    w.g0 = (w.s0 + t) * kFan;
    w.unit = kUnitBoxes;
    w.level = 1;
    w.first = w.g0;
    return;
  }
  w.ts.pass = 0;
  w.unit = w.s0 + kFan < sc.n_tops ? kUnitBoxes : kUnitEnd;
  if (w.unit == kUnitEnd) return;
  w.s0 += kFan;
  w.level = 0;
  w.first = w.s0;
}

// Start the walk of a ray: nothing entered, no hit, its first unit chosen.
// Every field is set, so nothing of the walk before stays live.
__device__ __forceinline__ void walk_start(const LeafScene& sc, LeafWalk& w,
                                           float ox, float oy, float oz,
                                           float dx, float dy, float dz) {
  w.ox = ox, w.oy = oy, w.oz = oz, w.dx = dx, w.dy = dy, w.dz = dz;
  w.ix = safe_inv(dx), w.iy = safe_inv(dy), w.iz = safe_inv(dz);
  w.h = LeafHit{SPT_BIG, 0, 0, false, false};
  w.ls.pass = w.gs.pass = w.ts.pass = 0;
#pragma unroll
  for (int j = 0; j < kFan; ++j) w.ls.enter[j] = w.gs.enter[j] = w.ts.enter[j] = 0.0f;
  w.s0 = -kFan, w.g0 = w.l0 = 0;
  w.level = w.first = 0;
  w.cnt = SweepCount{};
  walk_next(sc, w);
}

// Run a kUnitBoxes unit and choose the next. The level's table is
// s_top (shared memory) or a table in device memory, read through one
// generic pointer, so lanes at different levels test their boxes together.
__device__ __forceinline__ void walk_boxes(const LeafScene& sc,
                                           const float4* s_top, LeafWalk& w) {
  const float4* table = w.level == 0 ? s_top : w.level == 1 ? sc.group : sc.leaf;
  const int boxes = w.level == 0 ? sc.n_tops : w.level == 1 ? sc.n_groups : sc.n_leaves;
  const Slabs r = slabs<true>(table, w.first, min(kFan, boxes - w.first), w.ox,
                              w.oy, w.oz, w.ix, w.iy, w.iz);
  if (w.level == 0)
    w.ts = r;
  else if (w.level == 1)
    w.gs = r;
  else
    w.ls = r;
  walk_next(sc, w);
}

// A candidate hit (t, original index) is nearer than the best hit h: the
// test of leaf_hits.
__device__ __forceinline__ bool nearer(float t, int idx, const LeafHit& h) {
  return t < h.t || (h.hit && t == h.t && idx < h.idx);
}

// Lanes that test a leaf together in walk_leaves: of 16, 8, 4 and 2, 4
// measured fastest on the 200k field (PERF.md).
constexpr int kLeafLanes = 4;

// The kUnitLeaf units of the lanes in `want`, run by the whole warp (all 32
// lanes call this together): 32 / kLeafLanes leaves at a time, kLeafLanes
// lanes a leaf, each testing the leaf's triangles k, k + kLeafLanes, ...
// against the ray of the leaf's lane; the group's nearest hit, reduced over
// its lanes, is merged into that lane's best hit, and each lane of `want`
// then chooses its next unit. A hit is taken when it is nearer than the best
// (nearer()), so a leaf's result is the lexicographic minimum of (t,
// original index) over its hits nearer than the best hit, whatever the
// order of its tests: the hit of leaf_hits, bit for bit.
__device__ __forceinline__ void walk_leaves(const LeafScene& sc, LeafWalk& w,
                                            unsigned want, int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int kGroups = 32 / kLeafLanes;
  const int grp = lane / kLeafLanes, k = lane % kLeafLanes;
  for (unsigned left = want; left;) {
    // the next kGroups lanes of `left`: group g serves the g-th
    unsigned rest = left;
    int r = -1;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      if (rest && g == grp) r = __ffs(rest) - 1;
      rest &= rest - 1;
    }
    const unsigned served = left & ~rest;
    left = rest;
    const int src = r >= 0 ? r : __ffs(served) - 1;
    __syncwarp();
    const float ox = __shfl_sync(kAll, w.ox, src), oy = __shfl_sync(kAll, w.oy, src),
                oz = __shfl_sync(kAll, w.oz, src), dx = __shfl_sync(kAll, w.dx, src),
                dy = __shfl_sync(kAll, w.dy, src), dz = __shfl_sync(kAll, w.dz, src);
    const int first = __shfl_sync(kAll, w.first, src);
    LeafHit p{SPT_BIG, 0, 0, false, false};
    // the same number of steps in every lane: no lane loops alone
#pragma unroll 4
    for (int j0 = 0; j0 < sc.leaf_size; j0 += kLeafLanes) {
      const int j = j0 + k;
      if (r < 0 || j >= sc.leaf_size) continue;
      const float4* q = sc.rows + 4 * (size_t)(first + j);
      float tt, nd;
      if (!tri_hit4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3), ox, oy,
                    oz, dx, dy, dz, tt, nd))
        continue;
      const int idx = __ldg(&sc.ids[first + j].y);
      if (nearer(tt, idx, p)) p = LeafHit{tt, first + j, idx, true, nd < 0.0f};
    }
#pragma unroll
    for (int off = kLeafLanes / 2; off; off >>= 1) {
      __syncwarp();
      const float t = __shfl_xor_sync(kAll, p.t, off);
      const int row = __shfl_xor_sync(kAll, p.row, off);
      const int idx = __shfl_xor_sync(kAll, p.idx, off);
      const int f = __shfl_xor_sync(kAll, (int)p.hit | (int)p.front << 1, off);
      if ((f & 1) && nearer(t, idx, p)) p = LeafHit{t, row, idx, true, (f & 2) != 0};
    }
    // lane `lane` of `served` was served by group g
    const int src2 = kLeafLanes * __popc(served & ((1u << lane) - 1u)) & 31;
    __syncwarp();
    const float t = __shfl_sync(kAll, p.t, src2);
    const int row = __shfl_sync(kAll, p.row, src2);
    const int idx = __shfl_sync(kAll, p.idx, src2);
    const int f = __shfl_sync(kAll, (int)p.hit | (int)p.front << 1, src2);
    if (((served >> lane) & 1u) && (f & 1) && nearer(t, idx, w.h))
      w.h = LeafHit{t, row, idx, true, (f & 2) != 0};
  }
  if ((want >> lane) & 1u) walk_next(sc, w);
  __syncwarp();
}

// The kUnitBoxes units of the lanes in `want`, run by the whole warp (all
// 32 lanes call this together): four batches at a time, an eighth of the
// warp a batch, each lane testing one box of it against the ray of the
// batch's lane with box_slab; that lane gathers the pass bits (a ballot)
// and the entries (shuffles) into the Slabs of the batch's level, as
// slabs() would have made them, and each lane of `want` then chooses its
// next unit.
__device__ __forceinline__ void walk_boxes_together(const LeafScene& sc,
                                                    const float4* s_top,
                                                    LeafWalk& w, unsigned want,
                                                    int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  const int grp = lane >> 3, j = lane & 7;
  for (unsigned left = want; left;) {
    // the next four lanes of `left`: group g serves the g-th
    unsigned rest = left;
    int r = -1;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if (rest && g == grp) r = __ffs(rest) - 1;
      rest &= rest - 1;
    }
    const unsigned served = left & ~rest;
    left = rest;
    const int src = r >= 0 ? r : __ffs(served) - 1;
    __syncwarp();
    const float ox = __shfl_sync(kAll, w.ox, src), oy = __shfl_sync(kAll, w.oy, src),
                oz = __shfl_sync(kAll, w.oz, src), ix = __shfl_sync(kAll, w.ix, src),
                iy = __shfl_sync(kAll, w.iy, src), iz = __shfl_sync(kAll, w.iz, src);
    const int level = __shfl_sync(kAll, w.level, src);
    const int first = __shfl_sync(kAll, w.first, src);
    const float4* table = level == 0 ? s_top : level == 1 ? sc.group : sc.leaf;
    const int boxes = level == 0 ? sc.n_tops : level == 1 ? sc.n_groups : sc.n_leaves;
    float enter = 0.0f;
    bool pass = false;
    if (r >= 0 && j < min(kFan, boxes - first)) {
      const float4* q = table + 2 * (first + j);
      pass = box_slab(q[0], q[1], ox, oy, oz, ix, iy, iz, enter);
    }
    __syncwarp();
    const unsigned bits = __ballot_sync(kAll, pass);
    // lane `lane` of `served` was served by group g
    const int g = __popc(served & ((1u << lane) - 1u));
    Slabs res;
    res.pass = (bits >> (8 * g)) & 0xffu;
#pragma unroll
    for (int k = 0; k < kFan; ++k) res.enter[k] = __shfl_sync(kAll, enter, (8 * g + k) & 31);
    if ((served >> lane) & 1u) {
      if (w.level == 0)
        w.ts = res;
      else if (w.level == 1)
        w.gs = res;
      else
        w.ls = res;
    }
  }
  if ((want >> lane) & 1u) walk_next(sc, w);
  __syncwarp();
}
