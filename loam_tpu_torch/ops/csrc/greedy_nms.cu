// Greedy sector NMS: the serial feature pick of every scan line.
//
// Replaces: loam_tpu/ops/nms_pallas.py::_nms_kernel (reached through
// greedy_nms / _greedy_nms_flat, whose custom_vmap folds frames into TPU
// lanes). Reference semantics: extractSectorEdgeFeatures /
// extractSectorPlanarFeatures, features-inl.h:137-180.
//
// What it computes, per (frame, line): walk the sectors in order; in each,
// first the edge candidates (descending curvature), then the planar ones
// (ascending). A candidate that is -1 or already masked is a no-op that does
// not count toward the cap; an accepted one is written at slot `count`,
// clears points idx-(n-1) .. idx+(n-1) (clipped to the line, crossing sector
// boundaries, SURVEY 2.3(4)) and counts; the pass stops once count exceeds the
// cap, so cap+1 features are admitted (SURVEY 2.3(3)). Integer-exact.
//
// What bounds it on the H100: latency of a serial chain. The work is tiny
// (at most 2 * P candidate visits per line) but strictly ordered within a
// line, so a line is one thread and the card runs lines x frames threads
// (4,096 for a 64-frame batch of Ouster-64 scans, a few percent of its
// resident thread capacity). Each visit is a dependent local-memory
// read-modify-write of the mask.
//
// Design: one thread per line. The validity mask is bit-packed, 32 points per
// 32-bit word, into a per-thread array (P <= 2048 -> 64 words, in local
// memory that stays in L1), built from the byte mask at the start. Each
// sector's full slot list is walked (no count-derived bound, the fault
// loam_tpu's nms_pallas.py:189-198 records), with an early exit after the
// (cap+1)-th accept, which changes nothing since later visits are no-ops.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxWords = 64;  // P <= 2048

__device__ __forceinline__ void greedy_pass(const int* __restrict__ cand,
                                            int s_max, int max_f, int n, int P,
                                            uint32_t* mask,
                                            int* __restrict__ out) {
  int count = 0;
  for (int t = 0; t < s_max && count <= max_f; ++t) {
    const int idx = cand[t];
    if (idx < 0) continue;
    if (((mask[idx >> 5] >> (idx & 31)) & 1u) == 0u) continue;
    out[count] = idx;
    ++count;
    const int lo = max(idx - (n - 1), 0);
    const int hi = min(idx + (n - 1), P - 1);
    for (int q = lo; q <= hi; ++q) mask[q >> 5] &= ~(1u << (q & 31));
  }
}

__global__ void greedy_nms_kernel(const uint8_t* __restrict__ valid,
                                  const int* __restrict__ cand_e,
                                  const int* __restrict__ cand_p, int n_lines,
                                  int P, int S, int s_max, int max_e,
                                  int max_p, int n, int* __restrict__ out_e,
                                  int* __restrict__ out_p) {
  const long long line = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= n_lines) return;

  uint32_t mask[kMaxWords];
  const int words = (P + 31) >> 5;
  const uint8_t* v = valid + line * P;
  for (int w = 0; w < words; ++w) {
    uint32_t bits = 0;
    for (int b = 0; b < 32; ++b) {
      const int q = (w << 5) + b;
      if (q < P && v[q]) bits |= 1u << b;
    }
    mask[w] = bits;
  }

  const int cap_e = max_e + 1, cap_p = max_p + 1;
  int* oe = out_e + line * S * cap_e;
  int* op = out_p + line * S * cap_p;
  for (int i = 0; i < S * cap_e; ++i) oe[i] = -1;
  for (int i = 0; i < S * cap_p; ++i) op[i] = -1;

  const long long cbase = line * S * (long long)s_max;
  for (int s = 0; s < S; ++s) {
    greedy_pass(cand_e + cbase + (long long)s * s_max, s_max, max_e, n, P,
                mask, oe + s * cap_e);
    greedy_pass(cand_p + cbase + (long long)s * s_max, s_max, max_p, n, P,
                mask, op + s * cap_p);
  }
}

}  // namespace

extern "C" int loam_greedy_nms(const uint8_t* valid, const int* cand_e,
                               const int* cand_p, int n_lines, int P, int S,
                               int s_max, int max_e, int max_p, int n,
                               int* out_e, int* out_p, void* stream) {
  if (n_lines == 0) return 0;
  const int threads = 64;
  const int blocks = (n_lines + threads - 1) / threads;
  greedy_nms_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      valid, cand_e, cand_p, n_lines, P, S, s_max, max_e, max_p, n, out_e,
      out_p);
  return (int)cudaGetLastError();
}
