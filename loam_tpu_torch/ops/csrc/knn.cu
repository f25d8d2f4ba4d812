// Exact brute-force k-nearest-neighbor search, single-class (with neighbor
// coordinates and a query mask) and dual-class (edges and planars in one
// launch), with the Pallas kernel's visit pruning.
//
// Replaces: loam_tpu/ops/knn_pallas.py::_knn_kernel, reached through knn_run
// (pallas_call at :709) and through knn_dual_run (pallas_call at :946) inside
// every ICF iteration (loam_tpu/registration/icf.py). Semantics kept:
//   * squared distances from f32 coordinate differences, dx = t - q and
//     d2 = (dx*dx + dy*dy) + dz*dz, each step rounded on its own
//     (__fsub_rn / __fmul_rn / __fadd_rn, so no FMA contraction changes a
//     distance relative to the plain PyTorch version); never the
//     |q|^2 + |t|^2 - 2 q.t expansion, a GEMM, tensor cores or TF32
//     (knn_pallas.py:5-7);
//   * the top-k is ordered by (d2, target index): ascending distances with
//     first-index ties. The order is total, so the result does not depend on
//     the order in which targets are visited or partial lists are merged;
//   * slots start at (init_d2, index 0, coordinates 0): init_d2 is r^2 when a
//     radius applies (knn_pallas.py:196-203) and +inf otherwise; a candidate
//     enters only if it is lexicographically less than the current k-th;
//   * invalid targets sit at the +3e37 sentinel of knn_prep, so their d2
//     overflows to +inf and never enters;
//   * a masked query of the single search skips the search and writes the
//     initial slots (without that gate a sentinel query would find d2 = 0
//     against sentinel targets). The dual search has no query mask
//     (knn_dual_run passes none): its queries always hold finite coordinates.
// Outputs are (B, k, Q) index and d2 planes per class, and for the single
// search x/y/z planes of the neighbors; the Python wrapper applies
// isfinite & sqrt(d2) < max_dist.
//
// What bounds it on the H100: the FP32 instruction rate. A distance evaluation
// is 3 subtractions, 3 products, 2 additions and a compare, none of which may
// fuse, so the practical ceiling is half the card's published FP32 rate
// (which counts a fused multiply-add as two operations). The planar search
// of a scan pair is 19,584 x 19,584 evaluations against 0.23 MB of targets:
// memory traffic is negligible. Pruning lowers the evaluations, not the
// ceiling.
//
// Design:
//   * Register tiling. A thread carries kQpt queries and reads four targets
//     per coordinate plane with one 16-byte shared-memory load, so a step
//     evaluates 4 x kQpt distances from three loads (the loads are warp
//     broadcasts: every lane reads the same address). One branch per step
//     tests whether any of those distances enters a list; the insertion
//     network (K is a template parameter, <= 8, so it unrolls into register
//     moves) runs only then. The lists, kQpt x K x (d2, index), stay in
//     registers; coordinates are read from the target planes once at the end.
//   * Boxes (knn_pallas.py:362-397, _chunk_frames). knn_prep cuts each
//     class's target slots into boxes of `box` slots (the Pallas chunk
//     length: 256, or 128 from 32,768 slots) and gives each a unit xy
//     direction along its mean and its bounding box in that rotated frame;
//     an all-invalid box is inverted (lo > hi) and never visited. A box is
//     the unit of a visit: a staged tile holds kTile / box boxes, which need
//     not be neighbours.
//   * The block's list (knn_pallas.py:400-432, 611-656, 953-968). In the
//     prologue a block takes the bounding box of its searching queries and,
//     in shared memory, lists the boxes of its range whose separation from
//     it (in the box's frame) is below init_d2 -- and, with a seed bound and
//     list pruning on, at most the largest min(seed, r^2) of its queries --
//     ordered nearest first, ties by box index (a rank count in shared
//     memory). The running k-th distances then fall fast, and the gate
//     below skips the tail. The dual search's classes have their own boxes,
//     so no list holds a box of the other class.
//   * The gate (knn_pallas.py:285-327). Before a box is staged, every thread
//     tests each of its queries: point-to-box lower bound lb <= min(running
//     k-th, seed bound); the block votes on as many list entries at once as
//     the tile has free slots (one barrier a round). The k-th used is at
//     most one tile old, and k-th distances only fall, so a skipped box
//     cannot hold a candidate that would enter. Inside a staged tile a warp
//     skips the boxes that none of its queries can use (the same test with
//     the k-th of that moment; a tile whose every box it can use is searched
//     with no per-group test). A query that does not search holds -inf as
//     its k-th and never votes.
//   * Where nothing can be pruned (every box near every query, as in a map
//     whose slots are all live) the search costs what an unpruned one does
//     plus the list, the vote and the gate. Those are not what made it
//     slower: a build that skipped the rank sort and the vote for blocks
//     whose list held every box moved such a launch by under 1%. The hot
//     loop and the staging were: each query's seed bound lives in shared
//     memory and its |x| + |y| + |z| is recomputed where the gate needs it
//     (spills of the k = 5 search 132 -> ~50 bytes); nine threads a box put a
//     staged box's frame and bounds beside it, where thread 0 loaded all of
//     them; a box's copies are spread over the block slot by slot, where
//     the first `box` threads issued them all; and a tile whose every box
//     some query of the warp wants is searched with no per-group test.
//   * Soundness in float32. The lower bound is computed in the box's rotated
//     frame, u = cx*x + cy*y, v = cx*y - cy*x, so rounding could put it an
//     ulp above the d2 of a target on the box's face, and the <= test could
//     then skip an equal-distance, lower-index candidate. Each gap is cut by
//     kGapEps * s before squaring, s the sum of the query's |x|, |y|, |z| and
//     the box's largest |bound|, and the sum is scaled by kShrink. Why that
//     suffices: every rounded u, v (here and in knn_prep's three eager
//     operations) is within 2 ulp of the exact value for the float
//     direction, i.e. within 2^-22 (|x| + |y|) <= 2^-21 s; (cx, cy) is unit
//     within a few ulp, so exact gaps in its frame understate the true
//     distance by a relative few ulp; the rounded d2 of the search and the
//     rounded lb each lie within 4 ulp of their exact values. kGapEps =
//     16 FLT_EPSILON = 2^-19 > 2 x 2^-21 and kShrink = 1 - 32 FLT_EPSILON
//     cover these with room. A looser bound only adds visits.
//   * Seed bounds (knn_pallas.py:484-557): per-query upper bounds on the
//     k-th squared distance; the gate takes min(k-th, bound). The ICF loop's
//     two are computed here, in the prologue (seed_bound below): the warm
//     start from the last search's neighbours (prev_*) and the cold start
//     from the targets at the query's own rank, read straight from the
//     target planes. A tensor bound (seed) comes only from a 3-element
//     custom_knn of registration/icf.py, which computes it with tensor
//     operations. Results never copy a bound. A debug plane writes the bound
//     each query was gated with.
//   * Visiting order inside a tile. Sorted targets visited in index order
//     approach each query monotonically, so nearly all within the radius
//     would enter its list; the groups of four of a tile are visited in
//     bit-reversed order. Lists compare by (d2, index) in full, since
//     indices do not arrive ascending.
//   * Live-target bound. knn_prep computes per pair (and class) n_live, the
//     index of the last valid slot + 1, on the device. The kernel reads it
//     and visits [0, n_live) only: the voxel maps keep their valid slots as a
//     prefix, and the scan features are sorted with their masked slots last.
//     Indices are unchanged (no compaction), so outputs are identical.
//   * Split targets. The grid is (query blocks x target splits, summed over
//     the classes) x pairs. With splits > 1 each block searches one range of
//     [0, n_live), aligned to the boxes, and writes a partial top-k to
//     scratch; a second small kernel merges the partial lists by (d2,
//     index). The gate prunes every split: a partial list may then lack
//     candidates that the global top-k does not hold, but the merge is
//     unchanged. Exact and deterministic (the only atomics count visits).
//     The wrapper chooses the splits from the shapes alone, per class in
//     proportion to its targets, so the blocks of both classes carry similar
//     work; the heavier class is launched first. With splits == 1 the search
//     kernel writes the final outputs itself.
//   * Asynchronous staging. Tiles are double-buffered in shared memory with
//     cp.async: the next tile's boxes are chosen and loaded while the current
//     one is searched. Copies are 4 bytes wide because the planes start at
//     arbitrary multiples of 4 bytes (b * 3 * M, + M, + Me). A box that
//     passes n_live is padded in shared memory with the sentinel, never read
//     past the plane.
//   * Visit counter. With a visits pointer the search adds, per query block,
//     the boxes it staged (all splits together) and its query-box visits:
//     for each box a warp searched, the queries whose own gate passed it
//     (queries that do not search never pass). Times the box length, that
//     is the distance evaluations the search needed; a warp evaluates the
//     box for all its lanes' queries, and the count leaves the others out.
//   * The block shape (LOAM_KNN_THREADS x LOAM_KNN_QPT queries, LOAM_KNN_TILE
//     targets a tile) was chosen by python3 -m loam_tpu_torch.tune_knn on an
//     H100 before the pruning: 512 x 2, 1,024 targets.
//   * A k above 8 (the Pallas kernel takes any k) goes to a second, plain
//     kernel that keeps each query's list in the output planes
//     (knn_wide_kernel below); the same semantics, one thread a query, the
//     boxes gated in index order.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <cfloat>
#include <cstdint>

#ifndef LOAM_KNN_THREADS
#define LOAM_KNN_THREADS 512
#endif
#ifndef LOAM_KNN_QPT
#define LOAM_KNN_QPT 2
#endif
#ifndef LOAM_KNN_TILE
#define LOAM_KNN_TILE 1024
#endif

namespace {

constexpr int kThreads = LOAM_KNN_THREADS;  // threads a search block
constexpr int kWarps = kThreads / 32;
constexpr int kQpt = LOAM_KNN_QPT;          // queries a thread
constexpr int kTile = LOAM_KNN_TILE;        // targets a staged tile
constexpr int kBlockQ = kThreads * kQpt;    // queries a search block
constexpr int kMergeThreads = 256;
constexpr int kMaxSplits = 1024;
constexpr int kMaxRegK = 8;         // largest k whose lists stay in registers
constexpr int kWideThreads = 128;   // threads (queries) a block of the wide kernel
constexpr int kWideTile = 1024;     // largest box of the wide kernel
constexpr int kMinBox = 64;         // smallest box length
constexpr int kMaxSlots = kTile / kMinBox;  // boxes a staged tile holds at most
constexpr int kMaxBoxes = 1024;     // boxes of one block's range at most
constexpr float kSentinel = 3e37f;
constexpr float kGapEps = 16.0f * FLT_EPSILON;
constexpr float kShrink = 1.0f - 32.0f * FLT_EPSILON;
static_assert(kThreads % 32 == 0 && kTile % kMinBox == 0, "warp / box granularity");
static_assert(kMaxSlots <= 32, "a warp's skip mask is one word");

// One class of a launch: its targets, boxes, queries and where results go.
struct ClassDesc {
  const float* planes;   // x plane of pair 0; y and z follow at plane_stride
  const float* rot;      // (2, box_row) of pair 0: cx then cy; pairs at 2 * box_row
  const float* rbox;     // (6, box_row) of pair 0: u, v, z lo/hi; pairs at 6 * box_row
  const float* queries;  // (B, Q, 3)
  const uint8_t* qmask;  // (B, Q) or null: all queries search
  const float* seed;     // (B, Q) upper bounds on the k-th d2, or null
  const int* n_live;     // pair b's live-target bound at [b * live_stride]
  float* part_d2;        // (B, splits, K, Q) partial lists; unused if splits == 1
  int* part_idx;
  int* out_idx;          // (B, K, Q)
  float* out_d2;
  float* out_x;          // (B, K, Q) neighbor coordinates, or null
  float* out_y;
  float* out_z;
  int* visits;           // (B, query blocks, 2) boxes staged and query-box visits, or null
  float* bound_out;      // (B, Q) the seed bound each query was gated with, or null
  int Q;
  int splits;
  int live_stride;
  int box_row;           // boxes of a pair, both classes (the rows' length)
  float init_d2;
  // the seed bounds the kernel computes itself (seed_bound below), or none
  const float* prev_x;   // (B, K, Q) the last search's neighbour coordinates
  const float* prev_y;
  const float* prev_z;
  const uint8_t* prev_m; // (B, K, Q) their validity; null: no warm start
  int window;            // the cold start from the targets at the same rank
  int M;                 // target slots of a pair (the rank window's range)
};

struct SearchArgs {
  ClassDesc c[2];  // blocks [0, blocks0) of grid.x search c[0], the rest c[1]
  int blocks0;
  int box;         // slots a box; a power of two in [kMinBox, kTile]
  int box_shift;   // log2(box)
  int list_prune;  // drop boxes beyond every query's min(seed, r^2) from the lists
  long long plane_stride;  // floats between the x, y and z planes of a pair
  long long pair_stride;   // floats between pairs
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float dist2(float tx, float ty, float tz, float qx,
                                       float qy, float qz) {
  const float dx = __fsub_rn(tx, qx);
  const float dy = __fsub_rn(ty, qy);
  const float dz = __fsub_rn(tz, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

constexpr float kSlack = 1.000001f;  // knn_cuda.BOUND_SLACK
constexpr int kWindow = 8;           // window_candidates' w

// The gate's seed bound for query qi at (qx, qy, qz): the smaller of the
// bound given in cd.seed, the warm start (the largest squared distance to
// the last search's k neighbours, if all k were valid) and the cold start
// (the k-th smallest squared distance to the targets at slots qi - 4 ..
// qi + 3, each copy of the minimum dropped k - 1 times), the last two
// inflated by BOUND_SLACK and 1e-35 -- knn_cuda.seed_bound_from_packed,
// window_candidates and seed_bound_from_window with the same roundings, so
// the bound equals the plain functions' bit for bit. An invalid target slot
// holds the sentinel, whose d2 overflows to +inf as the plain window's
// masked entries are +inf. +inf when none is asked for.
__device__ __forceinline__ float seed_bound(const ClassDesc& cd, long long b, int qi,
                                            float qx, float qy, float qz, int k,
                                            const float* tx, const float* ty,
                                            const float* tz) {
  float bnd = cd.seed != nullptr ? cd.seed[b * cd.Q + qi] : CUDART_INF_F;
  if (cd.prev_m != nullptr) {
    float mx = -CUDART_INF_F;
    bool all = true;
    for (int s = 0; s < k; ++s) {
      const long long o = (b * k + s) * (long long)cd.Q + qi;
      mx = fmaxf(mx, dist2(cd.prev_x[o], cd.prev_y[o], cd.prev_z[o], qx, qy, qz));
      all = all && cd.prev_m[o] != 0;
    }
    if (all) bnd = fminf(bnd, __fadd_rn(__fmul_rn(mx, kSlack), 1e-35f));
  }
  if (cd.window) {
    float c[kWindow];
    const bool real = qi < min(cd.Q, cd.M);
#pragma unroll
    for (int o = 0; o < kWindow; ++o) {
      const int j = qi + o - kWindow / 2;
      c[o] = real && j >= 0 && j < cd.M ? dist2(tx[j], ty[j], tz[j], qx, qy, qz)
                                        : CUDART_INF_F;
    }
    float m = CUDART_INF_F;
    for (int p = 0; p < k; ++p) {
      m = c[0];
#pragma unroll
      for (int o = 1; o < kWindow; ++o) m = fminf(m, c[o]);
      if (p == k - 1) break;
#pragma unroll
      for (int o = 0; o < kWindow; ++o)
        if (c[o] == m) c[o] = CUDART_INF_F;
    }
    bnd = fminf(bnd, __fadd_rn(__fmul_rn(m, kSlack), 1e-35f));
  }
  return bnd;
}

// One box of a pair: its frame, its bounds and the largest |bound|.
struct Box {
  float cx, cy, b[6], s;
  bool empty;
};

__device__ __forceinline__ Box load_box(const float* rot, const float* rbox,
                                        int row, int c) {
  Box x;
  x.cx = __ldg(rot + c);
  x.cy = __ldg(rot + row + c);
  x.s = 0.f;
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    x.b[r] = __ldg(rbox + r * row + c);
    x.s = fmaxf(x.s, fabsf(x.b[r]));
  }
  x.empty = !(x.b[0] <= x.b[1]);  // inverted: no valid target
  return x;
}

__device__ __forceinline__ float gap(float lo, float hi, float a_lo, float a_hi) {
  return fmaxf(fmaxf(__fsub_rn(lo, a_hi), __fsub_rn(a_lo, hi)), 0.f);
}

// A lower bound on d2 from any point of [ulo, uhi] x [vlo, vhi] x [zlo, zhi]
// (in the box's frame) to any target of the box, deflated as the header says.
__device__ __forceinline__ float safe_gap2(const Box& x, float ulo, float uhi,
                                           float vlo, float vhi, float zlo,
                                           float zhi, float qs) {
  const float d = kGapEps * (qs + x.s);
  const float gu = fmaxf(gap(x.b[0], x.b[1], ulo, uhi) - d, 0.f);
  const float gv = fmaxf(gap(x.b[2], x.b[3], vlo, vhi) - d, 0.f);
  const float gz = fmaxf(gap(x.b[4], x.b[5], zlo, zhi) - d, 0.f);
  return (gu * gu + gv * gv + gz * gz) * kShrink;
}

// Point-to-box lower bound for one query; qs = |qx| + |qy| + |qz|.
__device__ __forceinline__ float point_lb(const Box& x, float qx, float qy,
                                          float qz, float qs) {
  const float u = __fadd_rn(__fmul_rn(x.cx, qx), __fmul_rn(x.cy, qy));
  const float v = __fsub_rn(__fmul_rn(x.cx, qy), __fmul_rn(x.cy, qx));
  return safe_gap2(x, u, u, v, v, qz, qz, qs);
}

// Inserts (d, j) into the ascending list if it is below the k-th in the
// (d2, index) order, and says whether it was. The full order, not the
// distance alone: targets are not visited in index order. An initial
// (init_d2, 0) slot is only ever passed by a strictly smaller distance, since
// no index is below 0.
template <int K>
__device__ __forceinline__ bool try_insert(float (&bd)[K], int (&bi)[K],
                                           float d, int j) {
  if (!(d < bd[K - 1] || (d == bd[K - 1] && j < bi[K - 1]))) return false;
  bd[K - 1] = d;
  bi[K - 1] = j;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    const bool lt = bd[s] < bd[s - 1] ||
                    (bd[s] == bd[s - 1] && bi[s] < bi[s - 1]);
    if (lt) {
      const float fd = bd[s];
      bd[s] = bd[s - 1];
      bd[s - 1] = fd;
      const int fi = bi[s];
      bi[s] = bi[s - 1];
      bi[s - 1] = fi;
    }
  }
  return true;
}

// Final outputs of one query: a slot holds a real candidate iff the query
// searched and the slot's d2 is below the initial value.
template <int K>
__device__ __forceinline__ void write_final(const ClassDesc& cd, long long b,
                                            int qi, bool searched,
                                            const float (&bd)[K],
                                            const int (&bi)[K],
                                            const float* tx, const float* ty,
                                            const float* tz) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const long long o = (b * K + s) * (long long)cd.Q + qi;
    const bool real = searched && bd[s] < cd.init_d2;
    cd.out_idx[o] = real ? bi[s] : 0;
    cd.out_d2[o] = real ? bd[s] : cd.init_d2;
    if (cd.out_x != nullptr) {
      cd.out_x[o] = real ? tx[bi[s]] : 0.f;
      cd.out_y[o] = real ? ty[bi[s]] : 0.f;
      cd.out_z[o] = real ? tz[bi[s]] : 0.f;
    }
  }
}

// Elementwise min of v[0..N) over the block, in place (every thread gets
// the result): one warp shuffle tree each, one barrier.
template <int N>
__device__ __forceinline__ void block_min(float (&v)[N], float (*red)[kWarps]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] = fminf(v[i], __shfl_xor_sync(0xffffffffu, v[i], o));
    if ((threadIdx.x & 31) == 0) red[i][threadIdx.x >> 5] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i)
    for (int w = 0; w < kWarps; ++w) v[i] = fminf(v[i], red[i][w]);
}

// Searches a staged tile of n_boxes boxes (slot[s]: the box in slot s) for
// one thread's queries, skipping the boxes whose bit in use is clear unless
// kAll. The groups of four targets are visited in bit-reversed order:
// sorted targets visited in index order approach a query monotonically, so
// nearly every one within the radius would enter its list (~150 insertions
// a query at scan scale); in this order about a quarter do.
template <int K, bool kAll>
__device__ __forceinline__ void search_tile(const float (*tile)[kTile], const int* slot, int n_boxes,
                                            int box_shift, unsigned use, const float (&qx)[kQpt],
                                            const float (&qy)[kQpt], const float (&qz)[kQpt],
                                            float (&bd)[kQpt][K], int (&bi)[kQpt][K]) {
  const int gshift = box_shift - 2;  // groups of four a box: 1 << gshift
  const int groups = n_boxes << gshift;
  const float4* sx4 = reinterpret_cast<const float4*>(tile[0]);
  const float4* sy4 = reinterpret_cast<const float4*>(tile[1]);
  const float4* sz4 = reinterpret_cast<const float4*>(tile[2]);
  int bits = 1;
  while ((1 << bits) < groups) ++bits;
  for (int v = 0; v < (1 << bits); ++v) {
    const int g = (int)(__brev((unsigned)v) >> (32 - bits));
    if (g >= groups) continue;
    if (!kAll && !((use >> (g >> gshift)) & 1u)) continue;
    const float4 X = sx4[g];
    const float4 Y = sy4[g];
    const float4 Z = sz4[g];
    float d[kQpt][4];
    bool hit[kQpt];
    bool any = false;
#pragma unroll
    for (int j = 0; j < kQpt; ++j) {
      d[j][0] = dist2(X.x, Y.x, Z.x, qx[j], qy[j], qz[j]);
      d[j][1] = dist2(X.y, Y.y, Z.y, qx[j], qy[j], qz[j]);
      d[j][2] = dist2(X.z, Y.z, Z.z, qx[j], qy[j], qz[j]);
      d[j][3] = dist2(X.w, Y.w, Z.w, qx[j], qy[j], qz[j]);
      // <= : an equal distance with a smaller index still enters
      const float kth = bd[j][K - 1];
      hit[j] = (d[j][0] <= kth) | (d[j][1] <= kth) | (d[j][2] <= kth) | (d[j][3] <= kth);
      any |= hit[j];
    }
    if (any) {
      const int j0 = (slot[g >> gshift] << box_shift) + ((g & ((1 << gshift) - 1)) << 2);
#pragma unroll
      for (int j = 0; j < kQpt; ++j) {
        if (hit[j]) {
#pragma unroll
          for (int c = 0; c < 4; ++c) try_insert<K>(bd[j], bi[j], d[j][c], j0 + c);
        }
      }
    }
  }
}

// Two blocks an SM for k <= 5 (64 registers a thread, a few spilled), one
// above (lists of 6-8 spill heavily at 64): the gate's state takes the
// search to ~115 registers unbounded, and at one block an SM the k = 5
// launch at scan scale took 0.51 ms where two blocks took 0.45, every other
// shape of tune_knn slower too (H100).
template <int K>
__global__ void __launch_bounds__(kThreads, K <= 5 ? 2 : 1)
    knn_search_kernel(const SearchArgs a) {
  __shared__ __align__(16) float stage[2][3][kTile];
  __shared__ int slot_box[2][kMaxSlots];  // the boxes of a staged tile
  __shared__ float s_key[kMaxBoxes];      // the list's sort keys (gaps)
  __shared__ int s_id[kMaxBoxes];
  __shared__ int s_lst[kMaxBoxes];        // the list, nearest first
  __shared__ float s_red[7][kWarps];
  __shared__ unsigned s_vote[2][kWarps];  // a vote round's wanted boxes, per warp
  __shared__ float s_box[2][kMaxSlots][9];  // the staged boxes: frame, bounds, |bound|
  __shared__ int s_cnt;
  __shared__ float s_sb[kQpt][kThreads];  // each query's seed bound, out of the registers

  const bool second = (int)blockIdx.x >= a.blocks0;
  const ClassDesc cd = second ? a.c[1] : a.c[0];
  const int x = second ? blockIdx.x - a.blocks0 : blockIdx.x;
  const int qblk = x / cd.splits;
  const int split = x - qblk * cd.splits;
  const long long b = blockIdx.y;
  const float* tx = cd.planes + b * a.pair_stride;
  const float* ty = tx + a.plane_stride;
  const float* tz = ty + a.plane_stride;
  const float* rot = cd.rot + b * 2 * cd.box_row;
  const float* rbox = cd.rbox + b * 6 * cd.box_row;
  const int box = a.box;

  // a warp's 32 * kQpt queries are contiguous: query j of a lane is 32 * j
  // slots after its first, so loads and stores coalesce and the queries of a
  // warp (neighbors in the sorted feature order) meet their targets in the
  // same boxes
  const int q0 = qblk * kBlockQ + (threadIdx.x >> 5) * (32 * kQpt) +
                 (threadIdx.x & 31);
  float qx[kQpt], qy[kQpt], qz[kQpt];
  float bd[kQpt][K];
  int bi[kQpt][K];
  unsigned searching = 0;  // bit j: query j is in range and not masked
  float lo3[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float hi3[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  float reach = -CUDART_INF_F;  // largest min(seed, init_d2) of the searching queries
#pragma unroll
  for (int j = 0; j < kQpt; ++j) {
    const int qi = q0 + 32 * j;
    bool on = qi < cd.Q;
    qx[j] = qy[j] = qz[j] = 0.f;
    float sbj = CUDART_INF_F;
    if (on) {
      const float* q = cd.queries + (b * cd.Q + qi) * 3;
      qx[j] = q[0];
      qy[j] = q[1];
      qz[j] = q[2];
      if (cd.qmask != nullptr) on = cd.qmask[b * cd.Q + qi] != 0;
      sbj = seed_bound(cd, b, qi, qx[j], qy[j], qz[j], K, tx, ty, tz);
      if (cd.bound_out != nullptr && split == 0) cd.bound_out[b * cd.Q + qi] = sbj;
    }
    s_sb[j][threadIdx.x] = sbj;  // read back by this thread only
    if (on) {
      searching |= 1u << j;
      lo3[0] = fminf(lo3[0], qx[j]);
      hi3[0] = fmaxf(hi3[0], qx[j]);
      lo3[1] = fminf(lo3[1], qy[j]);
      hi3[1] = fmaxf(hi3[1], qy[j]);
      lo3[2] = fminf(lo3[2], qz[j]);
      hi3[2] = fmaxf(hi3[2], qz[j]);
      reach = fmaxf(reach, fminf(sbj, cd.init_d2));
    }
    // nothing is below -inf: a query that does not search never inserts
    // and never votes for a box, with no test of its own in the loop
    const float start = on ? cd.init_d2 : -CUDART_INF_F;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[j][s] = start;
      bi[j][s] = 0;
    }
  }
  const bool warp_on = __any_sync(0xffffffffu, searching != 0);
  const bool block_on = __syncthreads_or(searching != 0);

  // this block's range of the live targets, whole boxes
  const int n_live = cd.n_live[b * cd.live_stride];
  const int per = (n_live + cd.splits - 1) / cd.splits;
  const int chunk = ((per + box - 1) >> a.box_shift) << a.box_shift;
  const int lo = min(split * chunk, n_live);
  const int hi = min(lo + chunk, n_live);

  // the list: the range's boxes near enough the queries' bounding box,
  // nearest first, ties by box index
  int cnt = 0;
  if (block_on && hi > lo) {
    // the queries' bounding box and largest reach: min of (lo, -hi, -reach)
    float red[7] = {lo3[0], lo3[1], lo3[2], -hi3[0], -hi3[1], -hi3[2], -reach};
    block_min(red, s_red);
    const float qlo[3] = {red[0], red[1], red[2]};
    const float qhi[3] = {-red[3], -red[4], -red[5]};
    const float tile_reach = -red[6];
    const bool prune = a.list_prune && (cd.seed != nullptr || cd.prev_m != nullptr || cd.window);
    const float qsum = fmaxf(fabsf(qlo[0]), fabsf(qhi[0])) +
                       fmaxf(fabsf(qlo[1]), fabsf(qhi[1])) +
                       fmaxf(fabsf(qlo[2]), fabsf(qhi[2]));
    if (threadIdx.x == 0) s_cnt = 0;
    __syncthreads();
    const int c0 = lo >> a.box_shift;  // lo is a multiple of box here
    const int c1 = (hi + box - 1) >> a.box_shift;
    for (int c = c0 + threadIdx.x; c < c1; c += kThreads) {
      const Box bx = load_box(rot, rbox, cd.box_row, c);
      if (bx.empty) continue;
      // the u / v extremes of the queries' xy rectangle (knn_pallas.py:410-422)
      const float ax0 = bx.cx * qlo[0], ax1 = bx.cx * qhi[0];
      const float ay0 = bx.cy * qlo[1], ay1 = bx.cy * qhi[1];
      const float bx0 = -bx.cy * qlo[0], bx1 = -bx.cy * qhi[0];
      const float by0 = bx.cx * qlo[1], by1 = bx.cx * qhi[1];
      const float g2 = safe_gap2(bx, fminf(ax0, ax1) + fminf(ay0, ay1),
                                 fmaxf(ax0, ax1) + fmaxf(ay0, ay1),
                                 fminf(bx0, bx1) + fminf(by0, by1),
                                 fmaxf(bx0, bx1) + fmaxf(by0, by1), qlo[2],
                                 qhi[2], qsum);
      if (!(g2 < cd.init_d2)) continue;
      if (prune && !(g2 <= tile_reach)) continue;
      const int e = atomicAdd(&s_cnt, 1);
      s_key[e] = g2;
      s_id[e] = c;
    }
    __syncthreads();
    cnt = s_cnt;
    for (int e = threadIdx.x; e < cnt; e += kThreads) {
      const float key = s_key[e];
      const int id = s_id[e];
      int rank = 0;
      for (int f = 0; f < cnt; ++f) {
        const float kf = s_key[f];
        rank += (kf < key) || (kf == key && s_id[f] < id);
      }
      s_lst[rank] = id;
    }
    __syncthreads();
  }

  // The gate: how many queries of this thread can use box bx? (A query
  // that does not search holds -inf as its k-th and never does.)
  auto wants = [&](const Box& bx) {
    int w = 0;
#pragma unroll
    for (int j = 0; j < kQpt; ++j)
      w += point_lb(bx, qx[j], qy[j], qz[j], fabsf(qx[j]) + fabsf(qy[j]) + fabsf(qz[j])) <=
           fminf(bd[j][K - 1], s_sb[j][threadIdx.x]);
    return w;
  };

  // Starts the copy of box c into slot sl of buffer buf, the copies spread
  // over the threads slot by slot, a ragged end padded with the sentinel;
  // nine threads put the box's frame, bounds and largest |bound| beside it.
  auto stage_box = [&](int buf, int sl, int c) {
    const int f = (int)threadIdx.x - sl * 9;
    if (f >= 0 && f < 9) {
      float v = 0.f;
      if (f < 2) {
        v = __ldg(rot + f * cd.box_row + c);
      } else if (f < 8) {
        v = __ldg(rbox + (f - 2) * cd.box_row + c);
      } else {
#pragma unroll
        for (int r = 0; r < 6; ++r) v = fmaxf(v, fabsf(__ldg(rbox + r * cd.box_row + c)));
      }
      s_box[buf][sl][f] = v;
      if (f == 0) slot_box[buf][sl] = c;
    }
    const int base = c << a.box_shift;
    const int nc = min(box, hi - base);
    float* sx = stage[buf][0] + (sl << a.box_shift);
    float* sy = stage[buf][1] + (sl << a.box_shift);
    float* sz = stage[buf][2] + (sl << a.box_shift);
    for (int e = ((int)threadIdx.x - (sl << a.box_shift)) & (kThreads - 1); e < box; e += kThreads) {
      if (e < nc) {
        cp_async4(sx + e, tx + base + e);
        cp_async4(sy + e, ty + base + e);
        cp_async4(sz + e, tz + base + e);
      } else {
        sx[e] = kSentinel;
        sy[e] = kSentinel;
        sz[e] = kSentinel;
      }
    }
  };

  // Chooses the next tile's boxes from the list and starts their copies into
  // buffer buf; returns how many. The gate takes the list's next free-slot
  // count of boxes at a time: each thread tests its queries against each,
  // the warps OR their masks, one barrier, and the boxes some query wants
  // are staged. The vote words are double-buffered by round: a warp writes
  // round r + 1's only after the barrier of round r, which every reader of
  // round r - 1's has passed.
  const int slots = kTile >> a.box_shift;
  int pos = 0, staged = 0, round = 0;
  auto next_tile = [&](int buf) {
    int filled = 0;
    while (filled < slots && pos < cnt) {
      const int n = min(slots - filled, cnt - pos);
      unsigned m = 0;
      for (int i = 0; i < n; ++i)
        if (wants(load_box(rot, rbox, cd.box_row, s_lst[pos + i])) > 0) m |= 1u << i;
      m = __reduce_or_sync(0xffffffffu, m);
      unsigned* vote = s_vote[round++ & 1];
      if ((threadIdx.x & 31) == 0) vote[threadIdx.x >> 5] = m;
      __syncthreads();
      m = 0;
      for (int w = 0; w < kWarps; ++w) m |= vote[w];
      for (int i = 0; i < n; ++i)
        if ((m >> i) & 1u) stage_box(buf, filled++, s_lst[pos + i]);
      pos += n;
    }
    cp_async_commit();
    staged += filled;
    return filled;
  };

  int needed = 0;  // query-box visits of this thread's queries that passed the gate
  int filled = cnt > 0 ? next_tile(0) : 0;
  for (int i = 0; filled > 0; ++i) {
    cp_async_wait_all();
    // this tile is complete for every thread, and every thread is done with
    // the tile before, whose buffer next_tile overwrites
    __syncthreads();
    const int cur = i & 1;
    const int n_now = filled;
    filled = next_tile(cur ^ 1);
    if (!warp_on) continue;
    // the boxes of this tile that some query of this warp can use, with the
    // k-th distances of this moment
    unsigned use = 0;
    for (int sl = 0; sl < n_now; ++sl) {
      const float* p = s_box[cur][sl];
      Box bx;
      bx.cx = p[0];
      bx.cy = p[1];
      for (int r = 0; r < 6; ++r) bx.b[r] = p[2 + r];
      bx.s = p[8];
      const int w = wants(bx);
      if (cd.visits != nullptr) needed += w;
      if (__any_sync(0xffffffffu, w > 0)) use |= 1u << sl;
    }
    if (use == (n_now == 32 ? ~0u : (1u << n_now) - 1)) {
      search_tile<K, true>(stage[cur], slot_box[cur], n_now, a.box_shift, use, qx, qy, qz, bd, bi);
    } else if (use != 0) {
      search_tile<K, false>(stage[cur], slot_box[cur], n_now, a.box_shift, use, qx, qy, qz, bd, bi);
    }
  }
  if (cd.visits != nullptr) {
    // boxes staged, and the query-box visits that passed the gate
    int* v = cd.visits + (b * ((cd.Q + kBlockQ - 1) / kBlockQ) + qblk) * 2;
    if (threadIdx.x == 0 && staged > 0) atomicAdd(v, staged);
    needed = __reduce_add_sync(0xffffffffu, needed);
    if ((threadIdx.x & 31) == 0 && needed > 0) atomicAdd(v + 1, needed);
  }

#pragma unroll
  for (int j = 0; j < kQpt; ++j) {
    const int qi = q0 + 32 * j;
    if (qi >= cd.Q) continue;
    const bool on = (searching >> j) & 1u;
    if (cd.splits == 1) {
      write_final<K>(cd, b, qi, on, bd[j], bi[j], tx, ty, tz);
    } else if (on) {  // the merge reads the mask itself
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const long long o =
            ((b * cd.splits + split) * K + s) * (long long)cd.Q + qi;
        cd.part_d2[o] = bd[j][s];
        cd.part_idx[o] = bi[j][s];
      }
    }
  }
}

// Merges the partial lists of the classes that were split: one thread per
// query, the splits in ascending order. A partial list is ascending, so its
// first entry that does not enter ends it.
template <int K>
__global__ void __launch_bounds__(kMergeThreads)
    knn_merge_kernel(const SearchArgs a) {
  const int i = blockIdx.x * kMergeThreads + threadIdx.x;
  const bool second = i >= a.c[0].Q;
  const ClassDesc cd = second ? a.c[1] : a.c[0];
  const int qi = second ? i - a.c[0].Q : i;
  if (qi >= cd.Q || cd.splits == 1) return;
  const long long b = blockIdx.y;
  const float* tx = cd.planes + b * a.pair_stride;
  const float* ty = tx + a.plane_stride;
  const float* tz = ty + a.plane_stride;

  const bool on = cd.qmask == nullptr || cd.qmask[b * cd.Q + qi] != 0;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = cd.init_d2;
    bi[s] = 0;
  }
  if (on) {
    for (int sp = 0; sp < cd.splits; ++sp) {
      const long long o0 = (b * cd.splits + sp) * K * (long long)cd.Q + qi;
      for (int s = 0; s < K; ++s) {
        const float dd = cd.part_d2[o0 + s * (long long)cd.Q];
        const int jj = cd.part_idx[o0 + s * (long long)cd.Q];
        if (!try_insert<K>(bd, bi, dd, jj)) break;
      }
    }
  }
  write_final<K>(cd, b, qi, on, bd, bi, tx, ty, tz);
}

// k above kMaxRegK: lists too long for registers. One thread a query, its
// list kept ascending in the output planes themselves ((B, k, Q): a warp's
// slots are adjacent, so its loads and stores coalesce); a candidate below
// the k-th shifts the tail down one slot and takes its place. The boxes are
// visited in index order, each staged in shared memory only when the block
// votes for it (the gate above), so an equal distance never passes an entry
// already in the list. No target splits and no list. Exact and simple rather
// than fast: the drivers ask for k <= 5.
__global__ void __launch_bounds__(kWideThreads)
    knn_wide_kernel(const SearchArgs a, int k) {
  __shared__ float stage[3][kWideTile];

  const bool second = (int)blockIdx.x >= a.blocks0;
  const ClassDesc cd = second ? a.c[1] : a.c[0];
  const int qblk = second ? blockIdx.x - a.blocks0 : blockIdx.x;
  const int qi = qblk * kWideThreads + threadIdx.x;
  const long long b = blockIdx.y;
  const float* tx = cd.planes + b * a.pair_stride;
  const float* ty = tx + a.plane_stride;
  const float* tz = ty + a.plane_stride;
  const float* rot = cd.rot + b * 2 * cd.box_row;
  const float* rbox = cd.rbox + b * 6 * cd.box_row;
  const long long Q = cd.Q;

  const bool in = qi < cd.Q;
  bool on = in;
  float qx = 0.f, qy = 0.f, qz = 0.f, sb = CUDART_INF_F;
  if (in) {
    const float* q = cd.queries + (b * Q + qi) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
    if (cd.qmask != nullptr) on = cd.qmask[b * Q + qi] != 0;
    sb = seed_bound(cd, b, qi, qx, qy, qz, k, tx, ty, tz);
    if (cd.bound_out != nullptr) cd.bound_out[b * Q + qi] = sb;
  }
  const float qs = fabsf(qx) + fabsf(qy) + fabsf(qz);
  float* od = cd.out_d2 + b * k * Q + qi;  // slot s at od[s * Q]
  int* oi = cd.out_idx + b * k * Q + qi;
  // nothing is below -inf: a query that does not search never inserts
  const float start = on ? cd.init_d2 : -CUDART_INF_F;
  if (in) {
    for (int s = 0; s < k; ++s) {
      od[s * Q] = start;
      oi[s * Q] = 0;
    }
  }
  float kth = start;  // the list's last entry, kept in registers
  int kth_i = 0;

  const int n_live = cd.n_live[b * cd.live_stride];
  const bool block_on = __syncthreads_or(on);
  const int n_boxes = block_on ? (n_live + a.box - 1) >> a.box_shift : 0;
  int staged = 0, voted = 0;
  for (int c = 0; c < n_boxes; ++c) {
    const Box bx = load_box(rot, rbox, cd.box_row, c);
    const bool want = !bx.empty && point_lb(bx, qx, qy, qz, qs) <= fminf(kth, sb);
    // also: every thread is done with the box before
    const int voters = __syncthreads_count(want);
    if (voters == 0) continue;
    voted += voters;
    const int base = c << a.box_shift;
    const int n = min(a.box, n_live - base);
    for (int e = threadIdx.x; e < n; e += kWideThreads) {
      stage[0][e] = tx[base + e];
      stage[1][e] = ty[base + e];
      stage[2][e] = tz[base + e];
    }
    __syncthreads();
    ++staged;
    if (!want) continue;
    for (int e = 0; e < n; ++e) {
      const float d = dist2(stage[0][e], stage[1][e], stage[2][e], qx, qy, qz);
      const int j = base + e;
      if (!(d < kth || (d == kth && j < kth_i))) continue;
      int s = k - 1;
      for (; s > 0; --s) {
        const float pd = od[(s - 1) * Q];
        const int pi = oi[(s - 1) * Q];
        if (!(d < pd || (d == pd && j < pi))) break;
        od[s * Q] = pd;
        oi[s * Q] = pi;
      }
      od[s * Q] = d;
      oi[s * Q] = j;
      kth = od[(k - 1) * Q];
      kth_i = oi[(k - 1) * Q];
    }
  }
  if (cd.visits != nullptr && threadIdx.x == 0) {
    int* v = cd.visits + (b * ((cd.Q + kWideThreads - 1) / kWideThreads) + qblk) * 2;
    v[0] = staged;
    v[1] = voted;  // only the queries that want a box evaluate it
  }

  if (!in) return;
  for (int s = 0; s < k; ++s) {
    const float d = od[s * Q];
    const int j = oi[s * Q];
    const bool real = on && d < cd.init_d2;
    oi[s * Q] = real ? j : 0;
    od[s * Q] = real ? d : cd.init_d2;
    if (cd.out_x != nullptr) {
      cd.out_x[(b * k + s) * Q + qi] = real ? tx[j] : 0.f;
      cd.out_y[(b * k + s) * Q + qi] = real ? ty[j] : 0.f;
      cd.out_z[(b * k + s) * Q + qi] = real ? tz[j] : 0.f;
    }
  }
}

inline int query_blocks(int Q) { return (Q + kBlockQ - 1) / kBlockQ; }

int launch_wide(SearchArgs a, int B, int k, cudaStream_t stream) {
  for (const ClassDesc& cd : a.c)
    if (cd.splits != 1) return (int)cudaErrorInvalidValue;
  if (a.box > kWideTile) return (int)cudaErrorInvalidValue;
  a.blocks0 = (a.c[0].Q + kWideThreads - 1) / kWideThreads;
  const int blocks1 = (a.c[1].Q + kWideThreads - 1) / kWideThreads;
  if (a.blocks0 + blocks1 == 0) return 0;
  knn_wide_kernel<<<dim3(a.blocks0 + blocks1, B), kWideThreads, 0, stream>>>(a, k);
  return (int)cudaGetLastError();
}

template <int K>
int launch(SearchArgs a, int B, cudaStream_t stream) {
  a.blocks0 = query_blocks(a.c[0].Q) * a.c[0].splits;
  const int blocks1 = query_blocks(a.c[1].Q) * a.c[1].splits;
  if (a.blocks0 + blocks1 == 0) return 0;
  knn_search_kernel<K><<<dim3(a.blocks0 + blocks1, B), kThreads, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (a.c[0].splits > 1 || a.c[1].splits > 1) {
    const int n = a.c[0].Q + a.c[1].Q;
    knn_merge_kernel<K><<<dim3((n + kMergeThreads - 1) / kMergeThreads, B),
                          kMergeThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// Checks what the launches assume; m[i] is class i's target slots.
int check(const SearchArgs& a, const int (&m)[2], int k) {
  if (a.box < kMinBox || a.box > kTile || (1 << a.box_shift) != a.box)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 2; ++i) {
    const ClassDesc& cd = a.c[i];
    if (cd.splits < 1 || cd.splits > kMaxSplits) return (int)cudaErrorInvalidValue;
    if (cd.splits > 1 && cd.Q > 0 && (cd.part_d2 == nullptr || cd.part_idx == nullptr))
      return (int)cudaErrorInvalidValue;
    // a block's range holds at most kMaxBoxes boxes (the wrapper splits)
    const long long per = ((long long)m[i] + cd.splits - 1) / cd.splits;
    if (k <= kMaxRegK && (per + a.box - 1) / a.box + 1 > kMaxBoxes)
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

int dispatch(const SearchArgs& a, const int (&m)[2], int B, int k, cudaStream_t s) {
  const int bad = check(a, m, k);
  if (bad != 0) return bad;
  switch (k) {
    case 1: return launch<1>(a, B, s);
    case 2: return launch<2>(a, B, s);
    case 3: return launch<3>(a, B, s);
    case 4: return launch<4>(a, B, s);
    case 5: return launch<5>(a, B, s);
    case 6: return launch<6>(a, B, s);
    case 7: return launch<7>(a, B, s);
    case 8: return launch<8>(a, B, s);
    default: return k > kMaxRegK ? launch_wide(a, B, k, s) : (int)cudaErrorInvalidValue;
  }
}

int log2_of(int box) {
  int s = 0;
  while ((1 << s) < box) ++s;
  return s;
}

}  // namespace

// Queries a search block covers: the wrapper plans the target splits with it
// and sizes the visit counters (the wide form's block: 128 queries).
extern "C" int loam_knn_block_queries(void) { return kBlockQ; }
extern "C" int loam_knn_wide_block_queries(void) { return kWideThreads; }
// Boxes one block's range may hold: the wrapper splits larger targets.
extern "C" int loam_knn_max_boxes(void) { return kMaxBoxes - 1; }

// Single-class search. tT (B, 3, M) planes, n_live (B,), rot (B, 2, C) and
// rbox (B, 6, C) the boxes of `box` slots, queries (B, Q, 3), qmask (B, Q)
// or null; the seed bound: seed (B, Q) or null, prev_* (B, k, Q) the last
// search's coordinates and validity (prev_m null: none), window nonzero for
// the rank-window cold start; part_* (B, splits, k, Q) scratch, unused when
// splits == 1; outputs (B, k, Q); visits (B, query blocks, 2) zeroed, or
// null; bound_out (B, Q) or null.
extern "C" int loam_knn(const float* tT, const int* n_live, const float* rot,
                        const float* rbox, int n_boxes, int box,
                        const float* queries, const uint8_t* qmask,
                        const float* seed, const float* prev_x, const float* prev_y,
                        const float* prev_z, const uint8_t* prev_m, int window,
                        int list_prune, int B, int M, int Q,
                        int k, float init_d2, int splits, float* part_d2,
                        int* part_idx, int* out_idx, float* out_d2,
                        float* out_x, float* out_y, float* out_z, int* visits,
                        float* bound_out, void* stream) {
  if (B == 0 || Q == 0) return 0;
  SearchArgs a = {};
  a.c[0] = ClassDesc{tT, rot, rbox, queries, qmask, seed, n_live, part_d2,
                     part_idx, out_idx, out_d2, out_x, out_y, out_z, visits,
                     bound_out, Q, splits, 1, n_boxes, init_d2,
                     prev_x, prev_y, prev_z, prev_m, window, M};
  a.c[1].splits = 1;  // no second class: Q = 0
  a.box = box;
  a.box_shift = log2_of(box);
  a.list_prune = list_prune;
  a.plane_stride = M;
  a.pair_stride = 3LL * M;
  const int m[2] = {M, 0};
  return dispatch(a, m, B, k, (cudaStream_t)stream);
}

// Dual-class search. tT (B, 3, Me + Mp) planes, edges first; n_live (B, 2),
// edge then planar; rot (B, 2, Ce + Cp) and rbox (B, 6, Ce + Cp), the edge
// boxes first; part_* hold the edge lists (B, splits_e, k, E) and then the
// planar lists (B, splits_p, k, P); outputs (B, k, E) and (B, k, P); visits
// (B, edge query blocks, 2) and (B, planar query blocks, 2), zeroed, or null.
// Planar indices are relative to the planar block. The planar class, with
// more targets and queries, takes the first blocks of the grid.
extern "C" int loam_knn_dual(const float* tT, const int* n_live, const float* rot,
                             const float* rbox, int ne_boxes, int np_boxes, int box,
                             int Me, int Mp, const float* q_edge, int E,
                             const float* q_plane, int P, int B, int k,
                             float init_e, float init_p, int splits_e,
                             int splits_p, float* part_d2, int* part_idx,
                             int* idx_e, float* d2_e, int* idx_p, float* d2_p,
                             int* visits_e, int* visits_p, void* stream) {
  if (B == 0 || E + P == 0) return 0;
  if (k < 1 || splits_e < 1) return (int)cudaErrorInvalidValue;
  const long long edge_part = (long long)B * splits_e * k * E;
  const int row = ne_boxes + np_boxes;
  SearchArgs a = {};
  a.c[0] = ClassDesc{tT + Me, rot + ne_boxes, rbox + ne_boxes, q_plane, nullptr,
                     nullptr, n_live + 1,
                     part_d2 ? part_d2 + edge_part : nullptr,
                     part_idx ? part_idx + edge_part : nullptr,
                     idx_p, d2_p, nullptr, nullptr, nullptr, visits_p, nullptr,
                     P, splits_p, 2, row, init_p};
  a.c[1] = ClassDesc{tT, rot, rbox, q_edge, nullptr, nullptr, n_live, part_d2,
                     part_idx, idx_e, d2_e, nullptr, nullptr, nullptr, visits_e,
                     nullptr, E, splits_e, 2, row, init_e};
  a.box = box;
  a.box_shift = log2_of(box);
  a.list_prune = 0;
  a.plane_stride = (long long)Me + Mp;
  a.pair_stride = 3LL * (Me + Mp);
  const int m[2] = {Mp, Me};
  return dispatch(a, m, B, k, (cudaStream_t)stream);
}
