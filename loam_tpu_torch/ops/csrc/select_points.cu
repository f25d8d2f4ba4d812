// Coordinate copy-out of the picked features: out[l, c] = pts[l, picks[l, c]],
// zeros where a pick is negative.
//
// Replaces: loam_tpu/ops/assemble_pallas.py::_select_kernel (called through
// select_points from loam_tpu/features/extract.py), which builds an
// iota-compare one-hot per line and reduces it on the TPU's vector unit
// because XLA's gather is slow there. Reference: the scan.at(idx) pushes of
// features-inl.h:146,168.
//
// What bounds it on the H100: launch latency. At the odometry paths' largest
// size (16 frames x 64 lines x 372 picks of float32) it reads 1.5 MB of picks
// and at most 4.6 MB of picked points and writes 4.6 MB; device memory needs
// under three microseconds for that, about what a launch itself costs. A
// gather is the natural form on a GPU, so there is no one-hot reduction.
//
// Design: a warp covers 32 consecutive slots of one line. Each lane reads one
// pick (one coalesced load a warp); the 96 output elements of the group are
// then written in three passes of 32 consecutive elements, so every store of a
// warp is one contiguous run: element e of the group belongs to slot e / 3,
// component e % 3, and its pick comes by __shfl_sync from the lane that read
// it. The reads of pts stay scattered, but inside one line's 12 KB (24 KB in
// float64), which the caches hold. A lane's three loads are started together,
// before its stores and without a branch: with a branch around each load the
// compiler runs load, store, load, store, and the warp waits for memory three
// times instead of once (on an H100: 0.0046 against 0.0040 ms at 1,024 lines).
// An exact copy: no arithmetic. Picks outside [0, P) yield zeros and read the
// line's first point instead, so a bad pick can never read out of bounds.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__global__ void select_points_kernel(const T* __restrict__ pts,
                                     const int* __restrict__ picks,
                                     long long n_groups, int groups_per_line,
                                     int P, int C, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long group =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (group >= n_groups) return;  // the whole warp leaves together
  const long long line = group / groups_per_line;
  const int c0 = (int)(group - line * groups_per_line) << 5;
  const int elements = 3 * min(32, C - c0);

  const int pick = c0 + lane < C ? picks[line * C + c0 + lane] : -1;
  // The three elements of a lane are read before any is written, and read
  // without a branch (a pick out of range reads the line's first point and is
  // zeroed after), so the loads are in flight together.
  const T* src = pts + line * P * 3;
  T value[3];
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const int e = pass * 32 + lane;
    const int slot = e / 3;
    const int p = __shfl_sync(kFull, pick, slot);
    const bool ok = p >= 0 && p < P;
    const T got = src[(ok ? p : 0) * 3 + (e - slot * 3)];
    value[pass] = ok ? got : T(0);
  }
  T* dst = out + (line * C + c0) * 3;
#pragma unroll
  for (int pass = 0; pass < 3; ++pass)
    if (pass * 32 + lane < elements) dst[pass * 32 + lane] = value[pass];
}

template <typename T>
int launch(const T* pts, const int* picks, int n_lines, int P, int C, T* out,
           cudaStream_t stream) {
  const int groups_per_line = (C + 31) / 32;
  const long long n_groups = (long long)n_lines * groups_per_line;
  if (n_groups == 0) return 0;
  if (P == 0)  // no point to pick: every slot is zero, and the kernel reads pts
    return (int)cudaMemsetAsync(out, 0, sizeof(T) * 3 * n_lines * (size_t)C, stream);
  const long long blocks = (n_groups + kWarpsPerBlock - 1) / kWarpsPerBlock;
  select_points_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      pts, picks, n_groups, groups_per_line, P, C, out);
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
