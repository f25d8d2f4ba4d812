// Exact brute-force k-nearest-neighbor search with neighbor coordinates.
//
// Replaces: loam_tpu/ops/knn_pallas.py::_knn_kernel (reached through knn_run
// inside every ICF iteration, loam_tpu/registration/icf.py). Semantics kept:
//   * squared distances from f32 coordinate differences, dx = t - q and
//     d2 = (dx*dx + dy*dy) + dz*dz, each step rounded on its own
//     (__fmul_rn / __fadd_rn, so no FMA contraction changes a distance
//     relative to the plain PyTorch version); never the |q|^2 + |t|^2 - 2 q.t
//     expansion, a GEMM or TF32 (knn_pallas.py:5-7);
//   * the running top-k is ordered by (d2, target index), which gives
//     ascending distances with first-index ties;
//   * slots start at (init_d2, index 0, coordinates 0): init_d2 is r^2 when a
//     radius applies (knn_pallas.py:196-203) and +inf otherwise; a candidate
//     enters only if it is lexicographically less than the current k-th;
//   * invalid targets sit at the +3e37 sentinel of knn_prep, so their d2
//     overflows to +inf and never enters;
//   * a masked query skips the search and writes the initial slots (without
//     that gate a sentinel query would find d2 = 0 against sentinel targets).
// Outputs are (B, k, Q) index, d2 and x/y/z planes; the Python wrapper applies
// isfinite & sqrt(d2) < max_dist.
//
// What bounds it on the H100: FP32 issue rate. The planar search of the main
// path is 19,584 x 19,584 per pair -- 3.8e8 distance evaluations of ~6 FP32
// operations plus a compare -- for 4 pairs per ICF iteration, while it reads
// only 0.23 MB of targets per pair. Memory traffic is negligible.
//
// Design: one thread per query, 128 queries per block, grid (query blocks,
// batch). Target tiles of 1,024 points are staged through shared memory
// (structure of arrays, every thread reads the same target: a broadcast, no
// bank conflicts). Each thread keeps its top-k (d2, index) in registers
// (K is a template parameter, <= 8, so the insertion network unrolls into
// register moves); the coordinates are copied from the target planes once at
// the end, so the hot loop carries only 2K registers. The chunk culling, the
// active lists and the seed bounds of the Pallas kernel only prune visits
// and are left to a later change.
//
// Second entry point, loam_knn_dual, replaces the dual-class launch of the
// same Pallas kernel (loam_tpu/ops/knn_pallas.py::knn_dual_run, its
// pallas_call at :946): edge queries search the edge targets and planar
// queries the planar targets in ONE launch per ICF iteration. The grid is
// (edge query blocks, then planar query blocks) x pairs; each block reads
// its class from blockIdx.x and runs the loop above over its class's block
// of the concatenated target planes, starting its slots at its own class's
// r^2 (the Pallas kernel starts both at the larger r^2 and filters per
// class afterwards; the valid outputs are the same). The dual search has no
// query mask: queries are never moved to the sentinel, so a sentinel query
// never meets a sentinel target. Scale on the scan-to-map path: 4,224 edge
// queries x 32,768 edge slots plus 19,584 planar queries x 131,072 planar
// slots, 2.7e9 distance evaluations a launch, FP32-bound as above.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;

// Runs one query against targets [0, M) of the coordinate planes tx/ty/tz,
// staged tile by tile through shared memory by the whole block, into the
// top-k (bd, bi) kept in registers. Every thread of the block must call it
// (it synchronises); inactive threads only help with the staging.
template <int K>
__device__ __forceinline__ void search_targets(
    const float* __restrict__ tx, const float* __restrict__ ty,
    const float* __restrict__ tz, int M, float qx, float qy, float qz,
    bool active, float (&bd)[K], int (&bi)[K], float* sx, float* sy,
    float* sz) {
  for (int base = 0; base < M; base += kTile) {
    const int n = min(kTile, M - base);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += kThreads) {
      sx[t] = tx[base + t];
      sy[t] = ty[base + t];
      sz[t] = tz[base + t];
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < n; ++t) {
      const float dx = __fsub_rn(sx[t], qx);
      const float dy = __fsub_rn(sy[t], qy);
      const float dz = __fsub_rn(sz[t], qz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      const int j = base + t;
      // candidate indices only grow, so (d2, j) < (bd[K-1], bi[K-1]) reduces
      // to d2 < bd[K-1] except against the initial index-0 slots, where an
      // equal d2 must not enter either
      if (d2 < bd[K - 1]) {
        bd[K - 1] = d2;
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
      }
    }
  }
}

template <int K>
__global__ void knn_kernel(const float* __restrict__ tT,
                           const float* __restrict__ queries,
                           const uint8_t* __restrict__ qmask, int M, int Q,
                           float init_d2, int* __restrict__ out_idx,
                           float* __restrict__ out_d2,
                           float* __restrict__ out_x,
                           float* __restrict__ out_y,
                           float* __restrict__ out_z) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];

  const long long b = blockIdx.y;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const float* tx = tT + b * 3 * (long long)M;
  const float* ty = tx + M;
  const float* tz = ty + M;

  bool active = qi < Q;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* q = queries + (b * Q + qi) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
    if (qmask != nullptr) active = qmask[b * Q + qi] != 0;
  }

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = init_d2;
    bi[s] = 0;
  }
  search_targets<K>(tx, ty, tz, M, qx, qy, qz, active, bd, bi, sx, sy, sz);

  if (qi >= Q) return;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const long long o = (b * K + s) * (long long)Q + qi;
    // a slot holds a real candidate iff its d2 is below the initial value
    const bool real = bd[s] < init_d2;
    out_idx[o] = real ? bi[s] : 0;
    out_d2[o] = real ? bd[s] : init_d2;
    out_x[o] = real ? tx[bi[s]] : 0.f;
    out_y[o] = real ? ty[bi[s]] : 0.f;
    out_z[o] = real ? tz[bi[s]] : 0.f;
  }
}

// The dual search: edge queries against the edge targets and planar queries
// against the planar targets in one launch. Grid (edge query blocks, then
// planar query blocks) x pairs; a block takes its class from blockIdx.x and
// searches only that class's block of the concatenated target planes
// (edges at [0, Me), planars at [Me, Me + Mp)), with that class's initial
// slot value, so the outputs equal two single searches. Indices are
// relative to the class's block. There is no query mask (as in
// knn_dual_run): every query searches, and the caller masks afterwards.
template <int K>
__global__ void knn_dual_kernel(const float* __restrict__ tT, int Me, int Mp,
                                const float* __restrict__ q_edge, int E,
                                const float* __restrict__ q_plane, int P,
                                int edge_blocks, float init_e, float init_p,
                                int* __restrict__ idx_e, float* __restrict__ d2_e,
                                int* __restrict__ idx_p,
                                float* __restrict__ d2_p) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];

  const long long b = blockIdx.y;
  const bool edge = (int)blockIdx.x < edge_blocks;
  const int blk = edge ? blockIdx.x : blockIdx.x - edge_blocks;
  const int qi = blk * kThreads + threadIdx.x;
  const int Q = edge ? E : P;
  const int M = edge ? Me : Mp;
  const float init_d2 = edge ? init_e : init_p;
  const float* queries = edge ? q_edge : q_plane;
  const long long mt = (long long)Me + Mp;
  const float* tx = tT + b * 3 * mt + (edge ? 0 : Me);
  const float* ty = tx + mt;
  const float* tz = ty + mt;

  const bool active = qi < Q;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* q = queries + (b * Q + qi) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = init_d2;
    bi[s] = 0;
  }
  search_targets<K>(tx, ty, tz, M, qx, qy, qz, active, bd, bi, sx, sy, sz);

  if (!active) return;
  int* out_idx = edge ? idx_e : idx_p;
  float* out_d2 = edge ? d2_e : d2_p;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const long long o = (b * K + s) * (long long)Q + qi;
    const bool real = bd[s] < init_d2;
    out_idx[o] = real ? bi[s] : 0;
    out_d2[o] = real ? bd[s] : init_d2;
  }
}

template <int K>
int launch(const float* tT, const float* queries, const uint8_t* qmask, int B,
           int M, int Q, float init_d2, int* out_idx, float* out_d2,
           float* out_x, float* out_y, float* out_z, cudaStream_t stream) {
  dim3 grid((Q + kThreads - 1) / kThreads, B);
  knn_kernel<K><<<grid, kThreads, 0, stream>>>(tT, queries, qmask, M, Q,
                                               init_d2, out_idx, out_d2,
                                               out_x, out_y, out_z);
  return (int)cudaGetLastError();
}

template <int K>
int launch_dual(const float* tT, int Me, int Mp, const float* q_edge, int E,
                const float* q_plane, int P, float init_e, float init_p,
                int* idx_e, float* d2_e, int* idx_p, float* d2_p, int B,
                cudaStream_t stream) {
  const int eb = (E + kThreads - 1) / kThreads;
  const int pb = (P + kThreads - 1) / kThreads;
  dim3 grid(eb + pb, B);
  knn_dual_kernel<K><<<grid, kThreads, 0, stream>>>(
      tT, Me, Mp, q_edge, E, q_plane, P, eb, init_e, init_p, idx_e, d2_e,
      idx_p, d2_p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int loam_knn(const float* tT, const float* queries,
                        const uint8_t* qmask, int B, int M, int Q, int k,
                        float init_d2, int* out_idx, float* out_d2,
                        float* out_x, float* out_y, float* out_z,
                        void* stream) {
  if (B == 0 || Q == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: return launch<1>(tT, queries, qmask, B, M, Q, init_d2, out_idx, out_d2, out_x, out_y, out_z, s);
    case 2: return launch<2>(tT, queries, qmask, B, M, Q, init_d2, out_idx, out_d2, out_x, out_y, out_z, s);
    case 3: return launch<3>(tT, queries, qmask, B, M, Q, init_d2, out_idx, out_d2, out_x, out_y, out_z, s);
    case 4: return launch<4>(tT, queries, qmask, B, M, Q, init_d2, out_idx, out_d2, out_x, out_y, out_z, s);
    case 5: return launch<5>(tT, queries, qmask, B, M, Q, init_d2, out_idx, out_d2, out_x, out_y, out_z, s);
    case 6: return launch<6>(tT, queries, qmask, B, M, Q, init_d2, out_idx, out_d2, out_x, out_y, out_z, s);
    case 7: return launch<7>(tT, queries, qmask, B, M, Q, init_d2, out_idx, out_d2, out_x, out_y, out_z, s);
    case 8: return launch<8>(tT, queries, qmask, B, M, Q, init_d2, out_idx, out_d2, out_x, out_y, out_z, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int loam_knn_dual(const float* tT, int Me, int Mp,
                             const float* q_edge, int E, const float* q_plane,
                             int P, int B, int k, float init_e, float init_p,
                             int* idx_e, float* d2_e, int* idx_p, float* d2_p,
                             void* stream) {
  if (B == 0 || E + P == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define LOAM_DUAL(KK) \
  return launch_dual<KK>(tT, Me, Mp, q_edge, E, q_plane, P, init_e, init_p, idx_e, d2_e, idx_p, d2_p, B, s)
  switch (k) {
    case 1: LOAM_DUAL(1);
    case 2: LOAM_DUAL(2);
    case 3: LOAM_DUAL(3);
    case 4: LOAM_DUAL(4);
    case 5: LOAM_DUAL(5);
    case 6: LOAM_DUAL(6);
    case 7: LOAM_DUAL(7);
    case 8: LOAM_DUAL(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LOAM_DUAL
}
