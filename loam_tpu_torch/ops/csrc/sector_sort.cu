// Sector sort: every (line, sector) curvature slice sorted ascending by the
// lexicographic key (curvature, position).
//
// Replaces: loam_tpu/ops/bitonic.py::_sort_kernel (the Pallas bitonic network
// called from loam_tpu/features/extract.py::_sector_sort), which sorts the
// (hi, lo, position) double-float keys of all slices at once with the slices
// on TPU lanes.
//
// What bounds it on the H100: nothing substantial. At the main path's size
// (16 frames x 64 lines x 6 sectors = 6,144 slices of <= 256 keys) it reads
// 8 MB of f64 curvature and writes 13 MB; each block runs a 36-stage network
// in shared memory, so the time is launch latency, shared-memory traffic and
// __syncthreads between stages.
//
// Design: one block per slice, one thread per padded slot (the slice padded
// to the next power of two, <= 1024). The block builds its slice straight from
// the (lines, P) curvature row -- sector s covers [s*pps, s*pps + size), the
// last sector absorbing the remainder -- so no (lines, S, s_max) copy is made
// first. Slots in [size, s_max) carry (+inf, P-1), exactly as loam_tpu's
// to_sectors pads; slots past s_max carry (+inf, INT_MAX) and sort last. The
// key is total (positions are unique within a slice, padding slots are fully
// identical), so the unstable bitonic network gives the stable-sort order.
// The curvature key is templated on double (precise path) and float.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <math_constants.h>

namespace {

template <typename T>
__device__ __forceinline__ T pos_inf();
template <>
__device__ __forceinline__ double pos_inf<double>() { return CUDART_INF; }
template <>
__device__ __forceinline__ float pos_inf<float>() { return CUDART_INF_F; }

template <typename T>
__global__ void sector_sort_kernel(const T* __restrict__ curv, int P, int S,
                                   int pps, int s_max, int npad,
                                   T* __restrict__ out_curv,
                                   int* __restrict__ out_pos) {
  extern __shared__ unsigned char smem_raw[];
  T* key = reinterpret_cast<T*>(smem_raw);
  int* pos = reinterpret_cast<int*>(key + npad);

  const long long line = blockIdx.x;
  const int s = blockIdx.y;
  const int t = threadIdx.x;
  const int start = s * pps;
  const int size = (s == S - 1) ? (P - start) : pps;

  if (t < size) {
    key[t] = curv[line * P + start + t];
    pos[t] = start + t;
  } else if (t < s_max) {
    key[t] = pos_inf<T>();
    pos[t] = P - 1;
  } else {
    key[t] = pos_inf<T>();
    pos[t] = INT_MAX;
  }
  __syncthreads();

  for (int k = 2; k <= npad; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int partner = t ^ j;
      if (partner > t) {
        const T ka = key[t], kb = key[partner];
        const int pa = pos[t], pb = pos[partner];
        const bool a_gt_b = (ka > kb) || (ka == kb && pa > pb);
        const bool ascending = (t & k) == 0;
        if (a_gt_b == ascending) {
          key[t] = kb;
          key[partner] = ka;
          pos[t] = pb;
          pos[partner] = pa;
        }
      }
      __syncthreads();
    }
  }

  if (t < s_max) {
    const long long o = (line * S + s) * (long long)s_max + t;
    out_curv[o] = key[t];
    out_pos[o] = pos[t];
  }
}

template <typename T>
int launch(const T* curv, int n_lines, int P, int S, int pps, int s_max,
           int npad, T* out_curv, int* out_pos, cudaStream_t stream) {
  if (n_lines == 0) return 0;
  const size_t smem = (size_t)npad * (sizeof(T) + sizeof(int));
  dim3 grid(n_lines, S);
  sector_sort_kernel<T><<<grid, npad, smem, stream>>>(curv, P, S, pps, s_max,
                                                      npad, out_curv, out_pos);
  return (int)cudaGetLastError();
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
