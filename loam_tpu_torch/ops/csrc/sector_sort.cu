// Sector sort: every (line, sector) curvature slice sorted ascending by the
// lexicographic key (curvature, position).
//
// Replaces: loam_tpu/ops/bitonic.py::_sort_kernel (the Pallas bitonic network
// called from loam_tpu/features/extract.py::_sector_sort), which sorts the
// (hi, lo, position) double-float keys of all slices at once with the slices
// on TPU lanes.
//
// What bounds it on the H100: the integer pipe, not the bytes. At 16 frames
// (6,144 slices of 174 slots, 21 MB in and out) the memory time is ~6 us, but
// the network is 36 stages x 256 slots a slice, each compare-exchange eight
// to eleven integer operations on a 96-bit item (~1,900 warp operations a
// slice beside 360 shuffles), and an SM runs integer operations at half the
// float32 rate (64 lanes a clock): ~22 us of scheduler cycles at the least.
// At one frame (384 slices, under one warp a scheduler) it is the latency of
// the 36 dependent stages, and of fetching the code: a network unrolled from
// end to end is tens of kilobytes that every lone warp reads once, cold. And
// the stores must coalesce: written out a lane's run at a time they cost as
// much as the whole network.
//
// Design: one warp per slice and one slice per block (more slices a block
// were never faster, and slower at one frame), the slice in registers, no
// block barrier, and shared memory only to turn the sorted positions around
// for the stores. The slice is padded to NPAD = 32 * E slots (E a power of two up to 32, a
// template parameter), E per lane. The loads are striped (slot e * 32 + lane,
// coalesced): the order going in does not matter to a sort.
// The network runs on the blocked index lane * E + e, so the stages with
// j < E exchange between a lane's own registers and only those with j >= E
// cross lanes, by __shfl_xor_sync with lane ^ (j / E) (for 256 slots: 21 and
// 15 of the 36 stages). The phases k <= E (a lane sorting its own slots) are
// unrolled; the phases k > E are one loop whose body is a shuffle stage (in
// an inner loop over the lane distance) and the in-register stages, so the
// code is a few hundred operations long and stays in the code cache. The
// sorted slice then lies contiguous per lane; its positions cross the warp
// through 1 KB of shared memory and go out 32 consecutive slots a store.
//
// The key: the curvature is mapped once, at the load, to an unsigned integer
// of its own width whose order is the order a stable torch.sort gives
// (sector_sort_reference): negative < -0.0 == +0.0 < positive < +inf < NaN,
// ties by position. -0.0 and +0.0 map to one value; every NaN, whatever its
// sign or payload, maps to the largest value, so NaN sorts after the padding
// slots (+inf, P-1), as torch.sort puts it, and NaNs keep their positions'
// order. For float32 the mapped key and the position are packed into one
// 64-bit word, so a compare is one integer compare and an exchange moves two
// registers; for float64 an item is the 64-bit key and the position. Slots
// past s_max hold an item above every other and are never written out. The
// key is total (positions are unique within a slice, padding slots are fully
// identical), so the unstable network gives the stable-sort order. The
// curvature written out is the original value, read again at the sorted
// position (the slice is in L1 by then), not the mapped one: -0.0 stays -0.0
// and a NaN keeps its bits.

#include <cuda_runtime.h>
#include <climits>
#include <math_constants.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Key;

template <>
struct Key<double> {
  struct Item {
    unsigned long long k;
    int p;
  };
  static __device__ __forceinline__ double inf() { return CUDART_INF; }
  static __device__ __forceinline__ Item make(double x, int p) {
    unsigned long long u = (unsigned long long)__double_as_longlong(x);
    if (x != x) u = ~0ull;
    else if (x == 0.0) u = 1ull << 63;
    else u = (u >> 63) ? ~u : (u | (1ull << 63));
    return Item{u, p};
  }
  static __device__ __forceinline__ Item last() { return Item{~0ull, INT_MAX}; }
  // All ones where a > b, (key, position) taken as one 96-bit integer: the
  // borrow of b - a through the three words, four operations in all. It
  // means (a.k > b.k || (a.k == b.k && a.p > b.p)) ? ~0u : 0u. The compiler
  // has no 96-bit type: written so, or as an unsigned __int128, the compare
  // came out at 12-14 operations.
  static __device__ __forceinline__ unsigned greater_mask(const Item& a, const Item& b) {
    unsigned mask, scratch;
    asm("sub.cc.u32 %1, %5, %2;\n\t"
        "subc.cc.u32 %1, %6, %3;\n\t"
        "subc.cc.u32 %1, %7, %4;\n\t"
        "subc.u32 %0, 0, 0;"
        : "=r"(mask), "=&r"(scratch)
        : "r"((unsigned)a.p), "r"((unsigned)a.k), "r"((unsigned)(a.k >> 32)),
          "r"((unsigned)b.p), "r"((unsigned)b.k), "r"((unsigned)(b.k >> 32)));
    return mask;
  }
  // x where the mask is clear, y where it is set: one three-input logic
  // operation a word (written as (x & ~m) | (y & m) it compiled to three)
  static __device__ __forceinline__ unsigned blend(unsigned x, unsigned y, unsigned mask) {
    unsigned d;
    asm("lop3.b32 %0, %1, %2, %3, 0xD8;" : "=r"(d) : "r"(x), "r"(y), "r"(mask));
    return d;
  }
  static __device__ __forceinline__ Item blend(const Item& x, const Item& y, unsigned mask) {
    const unsigned lo = blend((unsigned)x.k, (unsigned)y.k, mask);
    const unsigned hi = blend((unsigned)(x.k >> 32), (unsigned)(y.k >> 32), mask);
    return Item{((unsigned long long)hi << 32) | lo, (int)blend((unsigned)x.p, (unsigned)y.p, mask)};
  }
  // The pair (x, y) in ascending order if ``ascending``, else descending.
  static __device__ __forceinline__ void order(Item& x, Item& y, bool ascending) {
    const unsigned swap = greater_mask(x, y) ^ (ascending ? 0u : ~0u);
    const Item lo = blend(x, y, swap);
    y = blend(y, x, swap);
    x = lo;
  }
  // The smaller of a lane's item and its partner's if ``keep_min``, else the
  // larger.
  static __device__ __forceinline__ Item pick(const Item& mine, const Item& other, bool keep_min) {
    return blend(mine, other, greater_mask(mine, other) ^ (keep_min ? 0u : ~0u));
  }
  static __device__ __forceinline__ Item exchange(const Item& a, int lane_mask) {
    return Item{__shfl_xor_sync(FULL, a.k, lane_mask), __shfl_xor_sync(FULL, a.p, lane_mask)};
  }
  static __device__ __forceinline__ int pos(const Item& a) { return a.p; }
};

template <>
struct Key<float> {
  typedef unsigned long long Item;  // mapped key in the high word, position in the low
  static __device__ __forceinline__ float inf() { return CUDART_INF_F; }
  static __device__ __forceinline__ Item make(float x, int p) {
    unsigned u = __float_as_uint(x);
    if (x != x) u = ~0u;
    else if (x == 0.0f) u = 1u << 31;
    else u = (u >> 31) ? ~u : (u | (1u << 31));
    return ((unsigned long long)u << 32) | (unsigned)p;
  }
  static __device__ __forceinline__ Item last() { return ~0ull; }
  static __device__ __forceinline__ void order(Item& x, Item& y, bool ascending) {
    const bool swap = (x > y) == ascending;
    const Item lo = swap ? y : x;
    y = swap ? x : y;
    x = lo;
  }
  static __device__ __forceinline__ Item pick(Item mine, Item other, bool keep_min) {
    return ((mine > other) == keep_min) ? other : mine;
  }
  static __device__ __forceinline__ Item exchange(Item a, int lane_mask) {
    return __shfl_xor_sync(FULL, a, lane_mask);
  }
  static __device__ __forceinline__ int pos(Item a) { return (int)(unsigned)a; }
};

// The stage j (< E) within a lane's registers: the pair (e, e | j) ordered
// ascending where ``ascending`` (of the pair's lower index) says so.
template <typename T, int E, int J, typename Asc>
__device__ __forceinline__ void local_stage(typename Key<T>::Item (&a)[E], Asc ascending) {
  using K = Key<T>;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if ((e & J) == 0) K::order(a[e], a[e | J], ascending(e));
  }
}

// The stages j = J, J / 2, .. 1 within a lane's registers.
template <typename T, int E, int J, typename Asc>
__device__ __forceinline__ void local_stages(typename Key<T>::Item (&a)[E], Asc ascending) {
  if constexpr (J >= 1) {
    local_stage<T, E, J>(a, ascending);
    local_stages<T, E, J / 2>(a, ascending);
  }
}

// The phases k = K, 2K, .. E: a lane sorts its own E slots.
template <typename T, int E, int K>
__device__ __forceinline__ void local_phases(typename Key<T>::Item (&a)[E], int lane) {
  if constexpr (K <= E) {
    local_stages<T, E, K / 2>(a, [lane](int e) { return ((lane * E + e) & K) == 0; });
    local_phases<T, E, 2 * K>(a, lane);
  }
}

template <typename T, int E>
__global__ void __launch_bounds__(32)
sector_sort_kernel(const T* __restrict__ curv, int P, int S, int pps, int s_max,
                   T* __restrict__ out_curv, int* __restrict__ out_pos) {
  using K = Key<T>;
  using Item = typename K::Item;

  const int lane = threadIdx.x;
  const int slice = blockIdx.x;
  const int line = slice / S;
  const int s = slice - line * S;
  const int start = s * pps;
  const int size = (s == S - 1) ? (P - start) : pps;
  const T* __restrict__ row = curv + (long long)line * P;

  Item a[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int t = e * 32 + lane;
    if (t < size) a[e] = K::make(__ldg(row + start + t), start + t);
    else if (t < s_max) a[e] = K::make(K::inf(), P - 1);
    else a[e] = K::last();
  }

  // bitonic network on the index i = lane * E + e: stage (k, j) orders the
  // pair (i, i ^ j) ascending where (i & k) == 0 and descending elsewhere
  local_phases<T, E, 2>(a, lane);
#pragma unroll 1
  for (int k = 2 * E; k <= 32 * E; k <<= 1) {
    const bool ascending = ((lane * E) & k) == 0;
#pragma unroll 1
    for (int lane_mask = k / (2 * E); lane_mask > 0; lane_mask >>= 1) {
      // the lower index of the pair keeps the smaller item where ascending
      const bool keep_min = ((lane & lane_mask) == 0) == ascending;
      // up to eight exchanges in flight before the first compare waits for one
      constexpr int G = E < 8 ? E : 8;
#pragma unroll
      for (int g = 0; g < E; g += G) {
        Item other[G];
#pragma unroll
        for (int i = 0; i < G; ++i) other[i] = K::exchange(a[g + i], lane_mask);
#pragma unroll
        for (int i = 0; i < G; ++i) a[g + i] = K::pick(a[g + i], other[i], keep_min);
      }
    }
    local_stages<T, E, E / 2>(a, [ascending](int) { return ascending; });
  }

  // The sorted run lies contiguous per lane; written out so, every store
  // would touch 32 sectors for a fraction of each. The positions cross the
  // warp through shared memory (slot i at i + i / 32: no bank conflicts
  // either way) and go out striped, 32 consecutive slots a store.
  __shared__ int sorted_pos[32 * E + E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    sorted_pos[i + (i >> 5)] = K::pos(a[e]);
  }
  __syncwarp();
  const long long out = (long long)slice * s_max;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int t = r * 32 + lane;
    if (t < s_max) {
      const int p = sorted_pos[t + r];
      // only a padding slot carries P-1 outside the last sector, which has none
      const bool padding = (p == P - 1) && (s != S - 1);
      out_pos[out + t] = p;
      out_curv[out + t] = padding ? K::inf() : __ldg(row + p);
    }
  }
}

template <typename T, int E>
int launch_e(const T* curv, int n_slices, int P, int S, int pps, int s_max,
             T* out_curv, int* out_pos, cudaStream_t stream) {
  sector_sort_kernel<T, E><<<n_slices, 32, 0, stream>>>(
      curv, P, S, pps, s_max, out_curv, out_pos);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* curv, int n_lines, int P, int S, int pps, int s_max,
           int npad, T* out_curv, int* out_pos, cudaStream_t stream) {
  if (n_lines == 0) return 0;
  if ((long long)n_lines * S > INT_MAX) return (int)cudaErrorInvalidValue;
  const int n = n_lines * S;
  switch (npad <= 32 ? 1 : npad / 32) {  // slots a lane
    case 1: return launch_e<T, 1>(curv, n, P, S, pps, s_max, out_curv, out_pos, stream);
    case 2: return launch_e<T, 2>(curv, n, P, S, pps, s_max, out_curv, out_pos, stream);
    case 4: return launch_e<T, 4>(curv, n, P, S, pps, s_max, out_curv, out_pos, stream);
    case 8: return launch_e<T, 8>(curv, n, P, S, pps, s_max, out_curv, out_pos, stream);
    case 16: return launch_e<T, 16>(curv, n, P, S, pps, s_max, out_curv, out_pos, stream);
    case 32: return launch_e<T, 32>(curv, n, P, S, pps, s_max, out_curv, out_pos, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int loam_sector_sort_f64(const double* curv, int n_lines, int P,
                                    int S, int pps, int s_max, int npad,
                                    double* out_curv, int* out_pos,
                                    void* stream) {
  return launch<double>(curv, n_lines, P, S, pps, s_max, npad, out_curv,
                        out_pos, (cudaStream_t)stream);
}

extern "C" int loam_sector_sort_f32(const float* curv, int n_lines, int P,
                                    int S, int pps, int s_max, int npad,
                                    float* out_curv, int* out_pos,
                                    void* stream) {
  return launch<float>(curv, n_lines, P, S, pps, s_max, npad, out_curv,
                       out_pos, (cudaStream_t)stream);
}
