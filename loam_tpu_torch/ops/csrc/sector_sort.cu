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
// (A sector of more than 1,024 slots takes the block form at the end of this
// file.) The network runs on the blocked index lane * E + e, so the stages with
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

// ---- sectors over 1,024 slots ------------------------------------------------
//
// A slice padded to NPAD > 1,024 slots is sorted by one block of
// min(NPAD / 1,024, 8) warps, the slice in memory: in dynamic shared memory
// while it fits the opt-in limit (12 B a slot for float64, 8 for float32, so
// 16,384 slots take 198 KB), beyond that in a device-memory scratch that the
// wrapper allocates. It goes in chunks of 1,024 slots, a warp's worth of the
// form above (E = 32):
//  1. every chunk is sorted by a warp in registers with the network above and
//     stored ascending in even chunks and descending in odd ones, so that
//     each pair of chunks is a bitonic sequence;
//  2. the phases k = 2,048 .. NPAD: the stages with j >= 1,024 pair slots of
//     different chunks and run over the memory, a pair a thread at a time,
//     between __syncthreads; those with j < 1,024 stay inside a chunk, whose
//     slots all go one way, and a warp runs them in registers as above
//     (shuffles for j >= 32, a lane's own registers below);
//  3. the positions and the curvature go out as the warp form writes them.
// Slot i lives at i + i / 32 of the memory, so that a warp's blocked loads
// (lane l reads l * 32 + e) fall in distinct banks. The key and the order
// are the warp form's.

constexpr int kChunk = 1024;  // slots a warp sorts in registers: E = 32
constexpr int kWideWarps = 8;

__device__ __forceinline__ int phys(int i) { return i + (i >> 5); }

// A slice's slots in memory: the 64-bit items of float32; the keys, then
// the positions, of float64.
template <typename T>
struct Slots;

template <>
struct Slots<float> {
  static constexpr int kBytes = 8;
  unsigned long long* k;
  __device__ Slots(unsigned char* base, int) : k((unsigned long long*)base) {}
  __device__ __forceinline__ Key<float>::Item get(int i) const { return k[i]; }
  __device__ __forceinline__ void put(int i, Key<float>::Item a) const { k[i] = a; }
};

template <>
struct Slots<double> {
  static constexpr int kBytes = 12;
  unsigned long long* k;
  int* p;
  __device__ Slots(unsigned char* base, int n)
      : k((unsigned long long*)base), p((int*)(base + 8LL * n)) {}
  __device__ __forceinline__ Key<double>::Item get(int i) const {
    return Key<double>::Item{k[i], p[i]};
  }
  __device__ __forceinline__ void put(int i, const Key<double>::Item& a) const {
    k[i] = a.k;
    p[i] = a.p;
  }
};

// The stages j = 32 * lane_mask .. 32 of the network on a chunk in a warp's
// registers (blocked index lane * 32 + e), each a shuffle with lane ^ lane_mask.
template <typename T>
__device__ __forceinline__ void shuffle_stages(typename Key<T>::Item (&a)[32], int lane,
                                               int top, bool ascending) {
  using K = Key<T>;
  using Item = typename K::Item;
#pragma unroll 1
  for (int lane_mask = top; lane_mask > 0; lane_mask >>= 1) {
    const bool keep_min = ((lane & lane_mask) == 0) == ascending;
#pragma unroll
    for (int g = 0; g < 32; g += 8) {
      Item other[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) other[i] = K::exchange(a[g + i], lane_mask);
#pragma unroll
      for (int i = 0; i < 8; ++i) a[g + i] = K::pick(a[g + i], other[i], keep_min);
    }
  }
}

template <typename T>
__device__ __forceinline__ void load_chunk(const Slots<T>& mem, int c, int lane,
                                           typename Key<T>::Item (&a)[32]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) a[e] = mem.get(phys(c * kChunk + lane * 32 + e));
}

// The chunk back to memory, reversed (descending) if ``reverse``.
template <typename T>
__device__ __forceinline__ void store_chunk(const Slots<T>& mem, int c, int lane,
                                            const typename Key<T>::Item (&a)[32], bool reverse) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int i = lane * 32 + e;
    mem.put(phys(c * kChunk + (reverse ? kChunk - 1 - i : i)), a[e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kWideWarps)
sector_sort_wide_kernel(const T* __restrict__ curv, int P, int S, int pps, int s_max,
                        int npad, unsigned char* __restrict__ scratch,
                        T* __restrict__ out_curv, int* __restrict__ out_pos) {
  using K = Key<T>;
  using Item = typename K::Item;
  constexpr int E = 32;
  extern __shared__ __align__(16) unsigned char sort_slots[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int slice = blockIdx.x;
  const int line = slice / S;
  const int s = slice - line * S;
  const int start = s * pps;
  const int size = (s == S - 1) ? (P - start) : pps;
  const T* __restrict__ row = curv + (long long)line * P;
  const int n_phys = phys(npad);
  const Slots<T> mem(scratch ? scratch + (long long)slice * n_phys * Slots<T>::kBytes : sort_slots,
                     n_phys);
  const int chunks = npad / kChunk;

  for (int t = tid; t < npad; t += blockDim.x) {
    Item a;
    if (t < size) a = K::make(__ldg(row + start + t), start + t);
    else if (t < s_max) a = K::make(K::inf(), P - 1);
    else a = K::last();
    mem.put(phys(t), a);
  }
  __syncthreads();

  // 1. each chunk sorted in a warp's registers: ascending, then stored
  // reversed in the odd chunks
#pragma unroll 1
  for (int c = warp; c < chunks; c += warps) {
    Item a[E];
    load_chunk<T>(mem, c, lane, a);
    local_phases<T, E, 2>(a, lane);
#pragma unroll 1
    for (int k = 2 * E; k <= kChunk; k <<= 1) {
      const bool ascending = ((lane * E) & k) == 0;
      shuffle_stages<T>(a, lane, k / (2 * E), ascending);
      local_stages<T, E, E / 2>(a, [ascending](int) { return ascending; });
    }
    store_chunk<T>(mem, c, lane, a, c & 1);
  }

  // 2. the phases across chunks
#pragma unroll 1
  for (int k = 2 * kChunk; k <= npad; k <<= 1) {
#pragma unroll 1
    for (int j = k >> 1; j >= kChunk; j >>= 1) {
      __syncthreads();
      for (int q = tid; q < npad / 2; q += blockDim.x) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        Item x = mem.get(phys(i));
        Item y = mem.get(phys(i + j));
        K::order(x, y, (i & k) == 0);
        mem.put(phys(i), x);
        mem.put(phys(i + j), y);
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int c = warp; c < chunks; c += warps) {
      const bool ascending = ((c * kChunk) & k) == 0;
      Item a[E];
      load_chunk<T>(mem, c, lane, a);
      shuffle_stages<T>(a, lane, kChunk / (2 * E), ascending);
      local_stages<T, E, E / 2>(a, [ascending](int) { return ascending; });
      store_chunk<T>(mem, c, lane, a, false);
    }
  }
  __syncthreads();

  // 3. out, 32 consecutive slots a warp's store
  const long long out = (long long)slice * s_max;
  for (int t = tid; t < s_max; t += blockDim.x) {
    const int p = K::pos(mem.get(phys(t)));
    const bool padding = (p == P - 1) && (s != S - 1);
    out_pos[out + t] = p;
    out_curv[out + t] = padding ? K::inf() : __ldg(row + p);
  }
}

int shared_optin(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return 0;
  return optin;
}

// Slots a slice takes in the block form: NPAD, at least one chunk, with the
// bank padding.
long long wide_bytes(int npad, int key_bytes) {
  const int np = npad < kChunk ? kChunk : npad;
  return (long long)(np + (np >> 5)) * key_bytes;
}

template <typename T>
int launch_wide(const T* curv, int n, int P, int S, int pps, int s_max, int npad, int form,
                unsigned char* scratch, T* out_curv, int* out_pos, cudaStream_t stream) {
  const int np = npad < kChunk ? kChunk : npad;
  const int warps = np / kChunk < kWideWarps ? np / kChunk : kWideWarps;
  size_t smem = 0;
  if (form == 1) {
    int device = 0;
    cudaGetDevice(&device);
    const long long bytes = wide_bytes(npad, Slots<T>::kBytes);
    if (bytes > shared_optin(device)) return (int)cudaErrorInvalidValue;
    smem = (size_t)bytes;
    // raised once to the largest size asked for, so that a launch captured
    // into a CUDA graph after a first call makes no such call
    static size_t opted_in = 48 * 1024;
    if (smem > opted_in) {
      const cudaError_t err = cudaFuncSetAttribute(
          sector_sort_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      opted_in = smem;
    }
    scratch = nullptr;
  } else if (form != 2 || scratch == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  sector_sort_wide_kernel<T><<<n, 32 * warps, smem, stream>>>(curv, P, S, pps, s_max, np, scratch,
                                                             out_curv, out_pos);
  return (int)cudaGetLastError();
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
           int npad, int form, unsigned char* scratch, T* out_curv, int* out_pos,
           cudaStream_t stream) {
  if (n_lines == 0) return 0;
  if ((long long)n_lines * S > INT_MAX) return (int)cudaErrorInvalidValue;
  const int n = n_lines * S;
  if (form != 0)
    return launch_wide<T>(curv, n, P, S, pps, s_max, npad, form, scratch, out_curv, out_pos, stream);
  switch (npad <= 32 ? 1 : npad / 32) {  // slots a lane
    case 1: return launch_e<T, 1>(curv, n, P, S, pps, s_max, out_curv, out_pos, stream);
    case 2: return launch_e<T, 2>(curv, n, P, S, pps, s_max, out_curv, out_pos, stream);
    case 4: return launch_e<T, 4>(curv, n, P, S, pps, s_max, out_curv, out_pos, stream);
    case 8: return launch_e<T, 8>(curv, n, P, S, pps, s_max, out_curv, out_pos, stream);
    case 16: return launch_e<T, 16>(curv, n, P, S, pps, s_max, out_curv, out_pos, stream);
    case 32: return launch_e<T, 32>(curv, n, P, S, pps, s_max, out_curv, out_pos, stream);
    default: return (int)cudaErrorInvalidValue;  // the warp form holds 1,024 slots
  }
}

}  // namespace

// The form that slices padded to ``npad`` slots of ``key_bytes`` (12 for
// float64, 8 for float32) take on ``device``: 0 the warp form (npad <= 1,024), 1 the block
// form in shared memory, 2 the block form in device memory. ``force`` -1
// asks for the first form that takes npad, 0-2 for that form; -1 comes back
// if it cannot take npad.
extern "C" int loam_sector_sort_form(int npad, int key_bytes, int force, int device) {
  const bool takes[3] = {npad <= kChunk, wide_bytes(npad, key_bytes) <= shared_optin(device), true};
  if (force >= 0) return force < 3 && takes[force] ? force : -1;
  for (int f = 0; f < 3; ++f)
    if (takes[f]) return f;
  return -1;
}

// ``scratch``: for form 2, (npad + npad / 32) slots of 12 (float64) or 8
// (float32) bytes a slice, npad at least 1,024.
extern "C" int loam_sector_sort_f64(const double* curv, int n_lines, int P,
                                    int S, int pps, int s_max, int npad,
                                    int form, void* scratch, double* out_curv,
                                    int* out_pos, void* stream) {
  return launch<double>(curv, n_lines, P, S, pps, s_max, npad, form,
                        (unsigned char*)scratch, out_curv, out_pos,
                        (cudaStream_t)stream);
}

extern "C" int loam_sector_sort_f32(const float* curv, int n_lines, int P,
                                    int S, int pps, int s_max, int npad,
                                    int form, void* scratch, float* out_curv,
                                    int* out_pos, void* stream) {
  return launch<float>(curv, n_lines, P, S, pps, s_max, npad, form,
                       (unsigned char*)scratch, out_curv, out_pos,
                       (cudaStream_t)stream);
}
