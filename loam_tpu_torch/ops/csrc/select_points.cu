// Coordinate copy-out of the picked features: out[l, c] = pts[l, picks[l, c]],
// zeros where a pick is negative.
//
// Replaces: loam_tpu/ops/assemble_pallas.py::_select_kernel (called through
// select_points from loam_tpu/features/extract.py), which builds an
// iota-compare one-hot per line and reduces it on the TPU's vector unit
// because XLA's gather is slow there. Reference: the scan.at(idx) pushes of
// features-inl.h:146,168.
//
// What bounds it on the H100: launch latency. At the main path's size
// (16 frames x 64 lines x 372 picks) it moves about 2.3 MB; HBM time for that
// is under a microsecond. A gather is the natural form on a GPU, so there is
// no one-hot reduction.
//
// Design: one thread per output slot (line, c); the pick is read once and the
// three coordinates copied (an exact copy: no arithmetic). Picks outside
// [0, P) yield zeros, so a bad pick can never read out of bounds.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void select_points_kernel(const T* __restrict__ pts,
                                     const int* __restrict__ picks,
                                     long long total, int P, int C,
                                     T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long line = i / C;
  const int p = picks[i];
  const bool ok = p >= 0 && p < P;
  const T* src = pts + (line * P + (ok ? p : 0)) * 3;
  T* dst = out + i * 3;
  dst[0] = ok ? src[0] : T(0);
  dst[1] = ok ? src[1] : T(0);
  dst[2] = ok ? src[2] : T(0);
}

template <typename T>
int launch(const T* pts, const int* picks, int n_lines, int P, int C, T* out,
           cudaStream_t stream) {
  const long long total = (long long)n_lines * C;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  select_points_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      pts, picks, total, P, C, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int loam_select_points_f32(const float* pts, const int* picks,
                                      int n_lines, int P, int C, float* out,
                                      void* stream) {
  return launch<float>(pts, picks, n_lines, P, C, out, (cudaStream_t)stream);
}

extern "C" int loam_select_points_f64(const double* pts, const int* picks,
                                      int n_lines, int P, int C, double* out,
                                      void* stream) {
  return launch<double>(pts, picks, n_lines, P, C, out, (cudaStream_t)stream);
}
