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
// What bounds it on the H100: the latency of a serial chain, not bytes or
// operations. Within a line every accept depends on the one before (it may
// have suppressed the next candidate), so a line's time is its number of
// accepts times the latency of one step, whatever the card's width; the
// lines run side by side. The design keeps memory off that chain and makes
// the chain as short as the data allows.
//
// Design: a warp a line.
//  - The validity mask lives in registers, bit-packed: word w (points
//    32w .. 32w+31) in lane w % 32, one word a lane for P <= 1024 and two for
//    P <= 2048 (a wider line keeps it in memory: the forms at the end of
//    this file). It is built from coalesced byte loads and __ballot_sync.
//  - Candidates are read 32 at a time, one a lane, coalesced, and the loads
//    run six groups ahead of the walk (a whole list at 174 slots), so that a
//    run of empty groups does not wait for memory group by group. Each lane
//    probes its own candidate in the mask (one __shfl_sync of the word that
//    holds it); -1 entries and dead candidates never enter the reduction.
//  - The warp then takes the surviving lanes in list order: a live lane's
//    key is (lane, candidate), and one __reduce_min_sync names the next pick
//    and carries its index. After an accept every lane tests its own
//    candidate against the suppressed window by arithmetic and the warp
//    reduces again, so only accepts are steps of the chain: one reduction
//    and one compare. While the next reduction is under way each lane
//    clears the window's bits in its own mask words (a range mask, as
//    nms_pallas.py::_range_mask), for the groups and lists to come.
//    Measured on an H100: ~135 cycles a step, most of it the reduction's
//    own latency; a ballot, __ffs and a shuffle of the index in its place
//    took ~190.
//  - Picks are staged one a lane and leave as coalesced stores, 32 at a
//    time; the -1 padding is written by the same loop.
// Each sector's full slot list is walked (no count-derived bound, the fault
// loam_tpu's nms_pallas.py:189-198 records), with an early exit after the
// (cap+1)-th accept, which changes nothing since later visits are no-ops.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kAhead = 6;  // candidate groups in flight ahead of the walk
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;

// The mask word that holds point `idx`, from the lane that keeps it.
template <int WPL>
__device__ __forceinline__ uint32_t word_of(const uint32_t (&mask)[WPL],
                                            int idx) {
  const int w = idx >> 5;
  uint32_t word = __shfl_sync(kFull, mask[0], w & 31);
  if (WPL == 2) {
    const uint32_t upper = __shfl_sync(kFull, mask[WPL - 1], w & 31);
    if (w >> 5) word = upper;
  }
  return word;
}

template <int WPL>
__global__ void greedy_nms_kernel(const uint8_t* __restrict__ valid,
                                  const int* __restrict__ cand_e,
                                  const int* __restrict__ cand_p, int n_lines,
                                  int P, int S, int s_max, int max_e,
                                  int max_p, int n, int* __restrict__ out_e,
                                  int* __restrict__ out_p) {
  const int lane = threadIdx.x & 31;
  const long long line =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (line >= n_lines) return;  // the whole warp leaves together

  // The line's lists in visit order: list 2s is sector s's edge list, list
  // 2s+1 its planar list, each `groups` groups of 32 slots. The fetch cursor
  // runs kAhead groups ahead of the walk, across list boundaries.
  const long long cbase = line * S * (long long)s_max;
  const int* ce = cand_e + cbase;
  const int* cp = cand_p + cbase;
  const int lists = 2 * S;
  const int groups = (s_max + 31) >> 5;
  int f_list = 0, f_group = 0;
  // This lane's candidate of the cursor's group. The load is conditional on
  // purpose: it then writes its register whenever it arrives, whereas
  // `in_range ? list[t] : -1` selects on the loaded value at once and makes
  // the warp wait for memory at every fetch (on an H100: 0.043 against 0.032 ms).
  auto fetch = [&]() -> int {
    int c = -1;
    if (f_list < lists) {
      const int t = (f_group << 5) + lane;
      const int* list = ((f_list & 1) ? cp : ce) + (f_list >> 1) * s_max;
      if (t < s_max) c = list[t];
      if (++f_group == groups) {
        f_group = 0;
        ++f_list;
      }
    }
    return c;
  };
  int ahead[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) ahead[k] = fetch();

  uint32_t mask[WPL];
  const uint8_t* v = valid + line * P;
#pragma unroll
  for (int k = 0; k < WPL; ++k) {
    mask[k] = 0u;
#pragma unroll
    for (int w = 0; w < 32; ++w) {
      const int q = ((32 * k + w) << 5) + lane;
      const uint32_t bits = __ballot_sync(kFull, q < P && v[q] != 0);
      if (lane == w) mask[k] = bits;
    }
  }

  const int reach = n - 1;  // >= 0: the wrapper refuses n < 1
  for (int list = 0; list < lists; ++list) {
    const int max_f = (list & 1) ? max_p : max_e;
    int* out = ((list & 1) ? out_p : out_e) +
               (line * S + (list >> 1)) * (long long)(max_f + 1);
    int count = 0;
    int staged = -1;  // lane l: the pick of slot (count & ~31) + l
    for (int g = 0; g < groups; ++g) {
      const int c = ahead[0];
#pragma unroll
      for (int k = 0; k + 1 < kAhead; ++k) ahead[k] = ahead[k + 1];
      ahead[kAhead - 1] = fetch();

      const bool in_line = c >= 0 && c < P;
      const uint32_t word = word_of<WPL>(mask, in_line ? c : 0);
      // A live candidate's key is (lane, index), so the least key of the warp
      // names the next pick in list order and carries its index: one
      // __reduce_min_sync a step. kNone: dead, or not a candidate.
      uint32_t key = in_line && ((word >> (c & 31)) & 1u)
                         ? ((uint32_t)lane << 16) | (uint32_t)c
                         : kNone;
      uint32_t first = __reduce_min_sync(kFull, key);
      while (first != kNone) {
        const int idx = (int)(first & 0xffffu);
        if (lane == (count & 31)) staged = idx;
        ++count;
        if ((count & 31) == 0) {  // 32 picks staged: one coalesced store
          out[count - 32 + lane] = staged;
          staged = -1;
        }
        // whoever lies in the window is done, the pick itself included; once
        // the cap is reached nobody is left
        if ((uint32_t)(c - idx + reach) <= (uint32_t)(2 * reach) || count > max_f)
          key = kNone;
        first = __reduce_min_sync(kFull, key);
        // the window leaves the mask while the reduction is under way
        const int lo = max(idx - reach, 0);
        const int hi = min(idx + reach, P - 1);
#pragma unroll
        for (int k = 0; k < WPL; ++k) {
          const int base = (lane + 32 * k) << 5;
          const int a = max(lo - base, 0);
          const int b = min(hi - base, 31);
          if (a <= b) mask[k] &= ~((kFull >> (31 - b)) & (kFull << a));
        }
      }
      if (count > max_f) {
        // cap reached: the rest of the list is no-ops; move the cursor to the
        // next list and fetch anew unless it stands there already
        if (g + 1 < groups) {
          f_list = list + 1;
          f_group = 0;
#pragma unroll
          for (int k = 0; k < kAhead; ++k) ahead[k] = fetch();
        }
        break;
      }
    }
    // the staged tail, then the -1 padding
    for (int j = (count & ~31) + lane; j <= max_f; j += 32)
      out[j] = j < count ? staged : -1;
  }
}

// ---- lines wider than 2,048 points -------------------------------------------
//
// The register forms above hold at most two mask words a lane. A wider line
// keeps its mask in memory, one bit a point, ceil(P / 32) words a line: in
// dynamic shared memory (P / 8 bytes a warp: four warps of 65,536-point lines
// take 32 KB, and a block of one warp takes up to the opt-in 227 KB, about
// 1.8 M points), or beyond that in a device-memory scratch that the wrapper
// allocates. The walk is the register form's, with three changes:
//  - a lane probes its candidate's word with a load of its own, no shuffle;
//  - the window's words are cleared in memory, word w always by lane w % 32,
//    so that two accepts' clears of one word stay in one lane's program
//    order; a __syncwarp before each group's probe makes them visible;
//  - the reduction's key is the lane alone, and the pick's index comes from
//    that lane by a shuffle (the register form packs the index into the
//    key's low 16 bits, which a line of more than 65,536 points overflows):
//    one reduction and one shuffle a step.
// The semantics are the register form's: full lists walked, the window
// clipped to the line and across sectors, cap + 1 accepts.

constexpr int kWideWarpsPerBlock = 4;
constexpr uint32_t kNoLane = 32u;

__global__ void greedy_nms_wide_kernel(const uint8_t* __restrict__ valid,
                                       const int* __restrict__ cand_e,
                                       const int* __restrict__ cand_p,
                                       int n_lines, int P, int S, int s_max,
                                       int max_e, int max_p, int n,
                                       int* __restrict__ out_e,
                                       int* __restrict__ out_p,
                                       uint32_t* __restrict__ scratch) {
  extern __shared__ uint32_t wide_mask[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long line = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (line >= n_lines) return;  // the whole warp leaves together
  const int words = (P + 31) >> 5;
  uint32_t* mask = scratch ? scratch + line * words : wide_mask + (long long)warp * words;

  const long long cbase = line * S * (long long)s_max;
  const int* ce = cand_e + cbase;
  const int* cp = cand_p + cbase;
  const int lists = 2 * S;
  const int groups = (s_max + 31) >> 5;
  int f_list = 0, f_group = 0;
  auto fetch = [&]() -> int {
    int c = -1;
    if (f_list < lists) {
      const int t = (f_group << 5) + lane;
      const int* list = ((f_list & 1) ? cp : ce) + (f_list >> 1) * (long long)s_max;
      if (t < s_max) c = list[t];
      if (++f_group == groups) {
        f_group = 0;
        ++f_list;
      }
    }
    return c;
  };
  int ahead[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) ahead[k] = fetch();

  const uint8_t* v = valid + line * P;
  for (int w = 0; w < words; ++w) {
    const int q = (w << 5) + lane;
    const uint32_t bits = __ballot_sync(kFull, q < P && v[q] != 0);
    if (lane == (w & 31)) mask[w] = bits;
  }

  const int reach = n - 1;  // >= 0: the wrapper refuses n < 1
  for (int list = 0; list < lists; ++list) {
    const int max_f = (list & 1) ? max_p : max_e;
    int* out = ((list & 1) ? out_p : out_e) +
               (line * S + (list >> 1)) * (long long)(max_f + 1);
    int count = 0;
    int staged = -1;  // lane l: the pick of slot (count & ~31) + l
    for (int g = 0; g < groups; ++g) {
      const int c = ahead[0];
#pragma unroll
      for (int k = 0; k + 1 < kAhead; ++k) ahead[k] = ahead[k + 1];
      ahead[kAhead - 1] = fetch();

      __syncwarp();  // the last group's clears are visible to every lane
      const bool live = c >= 0 && c < P && ((mask[c >> 5] >> (c & 31)) & 1u);
      uint32_t key = live ? (uint32_t)lane : kNoLane;
      uint32_t first = __reduce_min_sync(kFull, key);
      while (first != kNoLane) {
        const int idx = __shfl_sync(kFull, c, first);
        if (lane == (count & 31)) staged = idx;
        ++count;
        if ((count & 31) == 0) {  // 32 picks staged: one coalesced store
          out[count - 32 + lane] = staged;
          staged = -1;
        }
        if ((uint32_t)(c - idx + reach) <= (uint32_t)(2 * reach) || count > max_f)
          key = kNoLane;
        first = __reduce_min_sync(kFull, key);
        // the window leaves the mask while the reduction is under way
        const int lo = max(idx - reach, 0);
        const int hi = min(idx + reach, P - 1);
        const int w_lo = lo >> 5;
        for (int w = w_lo + ((lane - w_lo) & 31); w <= (hi >> 5); w += 32) {
          const int a = max(lo - (w << 5), 0);
          const int b = min(hi - (w << 5), 31);
          mask[w] &= ~((kFull >> (31 - b)) & (kFull << a));
        }
      }
      if (count > max_f) {
        if (g + 1 < groups) {
          f_list = list + 1;
          f_group = 0;
#pragma unroll
          for (int k = 0; k < kAhead; ++k) ahead[k] = fetch();
        }
        break;
      }
    }
    for (int j = (count & ~31) + lane; j <= max_f; j += 32)
      out[j] = j < count ? staged : -1;
  }
}

int shared_optin(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return optin;
}

}  // namespace

// The form that lines of P points take: 0 the mask in registers (P <= 2,048),
// 1 in shared memory, 2 in device memory. ``force`` -1 asks for the first
// form that takes P, 0-2 for that form; -1 comes back if it cannot take P.
extern "C" int loam_greedy_nms_form(int P, int force, int device) {
  const long long warp_bytes = 4LL * ((P + 31) / 32);
  const bool takes[3] = {P <= 2048, warp_bytes <= shared_optin(device), true};
  if (force >= 0) return force < 3 && takes[force] ? force : -1;
  for (int f = 0; f < 3; ++f)
    if (takes[f]) return f;
  return -1;
}

// ``scratch``: ceil(P / 32) words a line in device memory for form 2.
extern "C" int loam_greedy_nms(const uint8_t* valid, const int* cand_e,
                               const int* cand_p, int n_lines, int P, int S,
                               int s_max, int max_e, int max_p, int n,
                               int form, uint32_t* scratch, int* out_e,
                               int* out_p, void* stream) {
  if (n_lines == 0) return 0;
  if (n < 1) return (int)cudaErrorInvalidValue;
  if (form == 0) {
    if (P > 2048) return (int)cudaErrorInvalidValue;  // the registers hold 2,048 points
    const int blocks = (n_lines + kWarpsPerBlock - 1) / kWarpsPerBlock;
    auto kernel = P <= 1024 ? greedy_nms_kernel<1> : greedy_nms_kernel<2>;
    kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
        valid, cand_e, cand_p, n_lines, P, S, s_max, max_e, max_p, n, out_e,
        out_p);
    return (int)cudaGetLastError();
  }
  int warps = kWideWarpsPerBlock;
  size_t smem = 0;
  if (form == 1) {
    int device = 0;
    cudaGetDevice(&device);
    const long long optin = shared_optin(device);
    const long long warp_bytes = 4LL * ((P + 31) / 32);
    if (warp_bytes * warps > optin) warps = 1;
    if (warp_bytes * warps > optin) return (int)cudaErrorInvalidValue;
    smem = (size_t)(warp_bytes * warps);
    // raised once to the largest size asked for, so that a launch captured
    // into a CUDA graph after a first call makes no such call
    static size_t opted_in = 48 * 1024;
    if (smem > opted_in) {
      const cudaError_t err = cudaFuncSetAttribute(
          greedy_nms_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
      opted_in = smem;
    }
    scratch = nullptr;
  } else if (form != 2 || scratch == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n_lines + warps - 1) / warps;
  greedy_nms_wide_kernel<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
      valid, cand_e, cand_p, n_lines, P, S, s_max, max_e, max_p, n, out_e,
      out_p, scratch);
  return (int)cudaGetLastError();
}
