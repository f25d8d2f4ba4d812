// Exact brute-force k-nearest-neighbor search, single-class (with neighbor
// coordinates and a query mask) and dual-class (edges and planars in one
// launch).
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
// memory traffic is negligible.
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
//   * Visiting order. A warp runs the insertion code whenever one of its
//     lanes has a hit, so hits must be rare. Sorted targets visited in index
//     order approach each query monotonically and nearly all of the ~1,700
//     within the radius enter its list (~150 insertions a query, several a
//     step). So a block starts at the tile at its queries' own relative
//     position of the range, and visits the groups of a tile in bit-reversed
//     order: a quarter of the insertions. Lists compare by (d2, index) in
//     full, since indices no longer arrive ascending.
//   * Live-target bound. knn_prep computes per pair (and class) n_live, the
//     index of the last valid slot + 1, on the device. The kernel reads it
//     and visits [0, n_live) only: the voxel maps keep their valid slots as a
//     prefix, and the scan features are sorted with their masked slots last.
//     Indices are unchanged (no compaction), so outputs are identical.
//   * Split targets. The grid is (query blocks x target splits, summed over
//     the classes) x pairs. With splits > 1 each block searches one range of
//     [0, n_live) and writes a partial top-k to scratch; a second small
//     kernel merges the partial lists by (d2, index). Exact and
//     deterministic, no atomics. The wrapper chooses the splits from the
//     shapes alone, per class in proportion to its targets, so the blocks of
//     both classes carry similar work; the heavier class is launched first.
//     With splits == 1 the search kernel writes the final outputs itself.
//   * Asynchronous staging. Target tiles are double-buffered in shared memory
//     with cp.async: the next tile loads while the current one is searched,
//     one __syncthreads() per tile. Copies are 4 bytes wide because the
//     planes start at arbitrary multiples of 4 bytes (b * 3 * M, + M, + Me);
//     at 6 copies per thread against ~20,000 arithmetic instructions per
//     tile their cost does not matter. A ragged tile end is padded in
//     shared memory with the sentinel, never read past the plane.
//   * The tile loop visits every tile of its range; a per-tile skip (the
//     Pallas kernel's chunk boxes, active lists and seed bounds, which only
//     prune visits) can be added at the top of the loop body.
//   * The block shape (LOAM_KNN_THREADS x LOAM_KNN_QPT queries, LOAM_KNN_TILE
//     targets a tile) was chosen by python3 -m loam_tpu_torch.tune_knn on an
//     H100: 512 x 2 is within 2% of the fastest variant at scan scale, the
//     fastest with every map slot live, and the one without register spills.
//     Four queries a thread evaluate faster but pay more for the insertions
//     (a warp's step then holds twice the distances, so it hits twice as
//     often), and at scan scale the insertions are a quarter of the time.
//   * A k above 8 (the Pallas kernel takes any k) goes to a second, plain
//     kernel that keeps each query's list in the output planes
//     (knn_wide_kernel below); the same semantics, one thread a query.

#include <cuda_runtime.h>
#include <math_constants.h>
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
constexpr int kQpt = LOAM_KNN_QPT;          // queries a thread
constexpr int kTile = LOAM_KNN_TILE;        // targets a staged tile
constexpr int kBlockQ = kThreads * kQpt;    // queries a search block
constexpr int kMergeThreads = 256;
constexpr int kMaxSplits = 1024;
constexpr int kMaxRegK = 8;         // largest k whose lists stay in registers
constexpr int kWideThreads = 128;   // threads (queries) a block of the wide kernel
constexpr int kWideTile = 1024;     // targets a staged tile of the wide kernel
constexpr float kSentinel = 3e37f;
static_assert(kThreads % 32 == 0 && kTile % 4 == 0, "warp / float4 granularity");

// One class of a launch: its targets, its queries and where its results go.
struct ClassDesc {
  const float* planes;   // x plane of pair 0; y and z follow at plane_stride
  const float* queries;  // (B, Q, 3)
  const uint8_t* qmask;  // (B, Q) or null: all queries search
  const int* n_live;     // pair b's live-target bound at [b * live_stride]
  float* part_d2;        // (B, splits, K, Q) partial lists; unused if splits == 1
  int* part_idx;
  int* out_idx;          // (B, K, Q)
  float* out_d2;
  float* out_x;          // (B, K, Q) neighbor coordinates, or null
  float* out_y;
  float* out_z;
  int Q;
  int splits;
  int live_stride;
  float init_d2;
};

struct SearchArgs {
  ClassDesc c[2];  // blocks [0, blocks0) of grid.x search c[0], the rest c[1]
  int blocks0;
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

template <int K>
__global__ void __launch_bounds__(kThreads)
    knn_search_kernel(const SearchArgs a) {
  __shared__ __align__(16) float stage[2][3][kTile];

  const bool second = (int)blockIdx.x >= a.blocks0;
  const ClassDesc cd = second ? a.c[1] : a.c[0];
  const int x = second ? blockIdx.x - a.blocks0 : blockIdx.x;
  const int qblk = x / cd.splits;
  const int split = x - qblk * cd.splits;
  const long long b = blockIdx.y;
  const float* tx = cd.planes + b * a.pair_stride;
  const float* ty = tx + a.plane_stride;
  const float* tz = ty + a.plane_stride;

  // a warp's 32 * kQpt queries are contiguous: query j of a lane is 32 * j
  // slots after its first, so loads and stores coalesce and the queries of a
  // warp (neighbors in the sorted feature order) meet their targets in the
  // same tiles
  const int q0 = qblk * kBlockQ + (threadIdx.x >> 5) * (32 * kQpt) +
                 (threadIdx.x & 31);
  float qx[kQpt], qy[kQpt], qz[kQpt];
  float bd[kQpt][K];
  int bi[kQpt][K];
  unsigned searching = 0;  // bit j: query j is in range and not masked
#pragma unroll
  for (int j = 0; j < kQpt; ++j) {
    const int qi = q0 + 32 * j;
    bool on = qi < cd.Q;
    qx[j] = qy[j] = qz[j] = 0.f;
    if (on) {
      const float* q = cd.queries + (b * cd.Q + qi) * 3;
      qx[j] = q[0];
      qy[j] = q[1];
      qz[j] = q[2];
      if (cd.qmask != nullptr) on = cd.qmask[b * cd.Q + qi] != 0;
    }
    if (on) searching |= 1u << j;
    // nothing is below -inf: a query that does not search never inserts,
    // with no test of its own in the loop
    const float start = on ? cd.init_d2 : -CUDART_INF_F;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[j][s] = start;
      bi[j][s] = 0;
    }
  }
  const bool warp_on = __any_sync(0xffffffffu, searching != 0);
  const bool block_on = __syncthreads_or(searching != 0);

  // this block's range of the live targets
  const int n_live = cd.n_live[b * cd.live_stride];
  const int chunk = (((n_live + cd.splits - 1) / cd.splits) + 3) & ~3;
  const int lo = min(split * chunk, n_live);
  const int hi = min(lo + chunk, n_live);
  const int ntiles = block_on ? (hi - lo + kTile - 1) / kTile : 0;

  // Visiting order. Both sides are sorted alike (by azimuth, or by Morton
  // key), so the targets nearest a block's queries tend to lie at the same
  // relative position of the range: that tile comes first, the others follow
  // round the range. It only tightens the k-th distance early; any order
  // gives the same lists.
  const int q_mid = min(qblk * kBlockQ + kBlockQ / 2, cd.Q - 1);
  const int first =
      ntiles > 0 ? min((int)((long long)q_mid * (hi - lo) / cd.Q) / kTile, ntiles - 1) : 0;
  auto tile_at = [&](int i) {
    const int t = first + i;
    return t < ntiles ? t : t - ntiles;
  };
  auto stage_tile = [&](int i) {  // the i-th tile visited, into buffer i & 1
    const int base = lo + tile_at(i) * kTile;
    const int n = min(kTile, hi - base);
    float* sx = stage[i & 1][0];
    float* sy = stage[i & 1][1];
    float* sz = stage[i & 1][2];
    for (int e = threadIdx.x; e < n; e += kThreads) {
      cp_async4(sx + e, tx + base + e);
      cp_async4(sy + e, ty + base + e);
      cp_async4(sz + e, tz + base + e);
    }
    for (int e = n + threadIdx.x; e < ((n + 3) & ~3); e += kThreads) {
      sx[e] = kSentinel;
      sy[e] = kSentinel;
      sz[e] = kSentinel;
    }
    cp_async_commit();
  };

  if (ntiles > 0) stage_tile(0);
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait_all();
    // this tile is complete for every thread, and every thread is done with
    // the tile before, whose buffer the next copies overwrite
    __syncthreads();
    if (i + 1 < ntiles) stage_tile(i + 1);
    if (!warp_on) continue;
    const int base = lo + tile_at(i) * kTile;
    const int groups = (min(kTile, hi - base) + 3) >> 2;
    const float4* sx4 = reinterpret_cast<const float4*>(stage[i & 1][0]);
    const float4* sy4 = reinterpret_cast<const float4*>(stage[i & 1][1]);
    const float4* sz4 = reinterpret_cast<const float4*>(stage[i & 1][2]);
    // The groups of four targets are visited in bit-reversed order. Sorted
    // targets visited in index order approach a query monotonically, so
    // nearly every one within the radius would enter its list (~150
    // insertions a query at scan scale); in this order about a quarter do.
    int bits = 1;
    while ((1 << bits) < groups) ++bits;
    for (int v = 0; v < (1 << bits); ++v) {
      const int g = (int)(__brev((unsigned)v) >> (32 - bits));
      if (g >= groups) continue;
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
        hit[j] = (d[j][0] <= kth) | (d[j][1] <= kth) | (d[j][2] <= kth) |
                 (d[j][3] <= kth);
        any |= hit[j];
      }
      if (any) {
        const int j0 = base + 4 * g;
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
// the k-th shifts the tail down one slot and takes its place. Targets are
// staged a tile at a time in shared memory and visited in index order, so an
// equal distance never passes an entry already in the list. No target
// splits. Exact and simple rather than fast: the drivers ask for k <= 5.
__global__ void __launch_bounds__(kWideThreads)
    knn_wide_kernel(const SearchArgs a, int k) {
  __shared__ float stage[3][kWideTile];

  const bool second = (int)blockIdx.x >= a.blocks0;
  const ClassDesc cd = second ? a.c[1] : a.c[0];
  const int qi = (second ? blockIdx.x - a.blocks0 : blockIdx.x) * kWideThreads + threadIdx.x;
  const long long b = blockIdx.y;
  const float* tx = cd.planes + b * a.pair_stride;
  const float* ty = tx + a.plane_stride;
  const float* tz = ty + a.plane_stride;
  const long long Q = cd.Q;

  const bool in = qi < cd.Q;
  bool on = in;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (in) {
    const float* q = cd.queries + (b * Q + qi) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
    if (cd.qmask != nullptr) on = cd.qmask[b * Q + qi] != 0;
  }
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
  for (int base = 0; block_on && base < n_live; base += kWideTile) {
    const int n = min(kWideTile, n_live - base);
    __syncthreads();  // every thread is done with the tile before
    for (int e = threadIdx.x; e < n; e += kWideThreads) {
      stage[0][e] = tx[base + e];
      stage[1][e] = ty[base + e];
      stage[2][e] = tz[base + e];
    }
    __syncthreads();
    if (!on) continue;
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

int dispatch(const SearchArgs& a, int B, int k, cudaStream_t s) {
  for (const ClassDesc& cd : a.c) {
    if (cd.splits < 1 || cd.splits > kMaxSplits) return (int)cudaErrorInvalidValue;
    if (cd.splits > 1 && cd.Q > 0 && (cd.part_d2 == nullptr || cd.part_idx == nullptr))
      return (int)cudaErrorInvalidValue;
  }
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

}  // namespace

// Queries a search block covers: the wrapper plans the target splits with it.
extern "C" int loam_knn_block_queries(void) { return kBlockQ; }

// Single-class search. tT (B, 3, M) planes, n_live (B,), queries (B, Q, 3),
// qmask (B, Q) or null; part_* (B, splits, k, Q) scratch, unused when
// splits == 1; outputs (B, k, Q).
extern "C" int loam_knn(const float* tT, const int* n_live,
                        const float* queries, const uint8_t* qmask, int B,
                        int M, int Q, int k, float init_d2, int splits,
                        float* part_d2, int* part_idx, int* out_idx,
                        float* out_d2, float* out_x, float* out_y,
                        float* out_z, void* stream) {
  if (B == 0 || Q == 0) return 0;
  SearchArgs a = {};
  a.c[0] = ClassDesc{tT, queries, qmask, n_live, part_d2, part_idx, out_idx,
                     out_d2, out_x, out_y, out_z, Q, splits, 1, init_d2};
  a.c[1].splits = 1;  // no second class: Q = 0
  a.plane_stride = M;
  a.pair_stride = 3LL * M;
  return dispatch(a, B, k, (cudaStream_t)stream);
}

// Dual-class search. tT (B, 3, Me + Mp) planes, edges first; n_live (B, 2),
// edge then planar; part_* hold the edge lists (B, splits_e, k, E) and then
// the planar lists (B, splits_p, k, P); outputs (B, k, E) and (B, k, P).
// Planar indices are relative to the planar block. The planar class, with
// more targets and queries, takes the first blocks of the grid.
extern "C" int loam_knn_dual(const float* tT, const int* n_live, int Me,
                             int Mp, const float* q_edge, int E,
                             const float* q_plane, int P, int B, int k,
                             float init_e, float init_p, int splits_e,
                             int splits_p, float* part_d2, int* part_idx,
                             int* idx_e, float* d2_e, int* idx_p, float* d2_p,
                             void* stream) {
  if (B == 0 || E + P == 0) return 0;
  if (k < 1 || splits_e < 1) return (int)cudaErrorInvalidValue;
  const long long edge_part = (long long)B * splits_e * k * E;
  SearchArgs a = {};
  a.c[0] = ClassDesc{tT + Me, q_plane, nullptr, n_live + 1,
                     part_d2 ? part_d2 + edge_part : nullptr,
                     part_idx ? part_idx + edge_part : nullptr,
                     idx_p, d2_p, nullptr, nullptr, nullptr, P, splits_p, 2, init_p};
  a.c[1] = ClassDesc{tT, q_edge, nullptr, n_live, part_d2, part_idx,
                     idx_e, d2_e, nullptr, nullptr, nullptr, E, splits_e, 2, init_e};
  a.plane_stride = (long long)Me + Mp;
  a.pair_stride = 3LL * (Me + Mp);
  return dispatch(a, B, k, (cudaStream_t)stream);
}
