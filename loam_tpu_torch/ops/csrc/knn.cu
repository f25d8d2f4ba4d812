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

#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;

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
