// The mesh's gather over peer memory: every rank's bytes, concatenated in
// rank order on every rank, as dist.all_gather_into_tensor gives them
// (loam_tpu_torch/ops/peer_cuda.py, parallel/collectives.py).
//
// It replaces no Pallas kernel: loam_tpu leaves its collectives to XLA
// (the sharded kNN's all-gather, distributed.py:83; the insert's psum,
// :190; the pose graph's psum of H, b and the cost, pose_graph.py:281-283),
// which places them inside its jitted while loops and conds. NCCL 2.28.9
// refuses a collective captured inside a CUDA-graph WHILE or IF body past
// one rank, so the port gathers with these kernels, which a graph captures
// anywhere: no host read, no host copy, and every argument fixed at the
// capture (a replay runs its nodes with the arguments of the capture).
//
// State, per mesh and rank, made with cudaMalloc and shared with the other
// ranks through cudaIpcGetMemHandle / cudaIpcOpenMemHandle:
//   mailbox  two slots of `cap` bytes; gather e writes slot e % 2. A larger
//            one is made where a gather outgrows it (every rank at the same
//            gather); the earlier ones and their mappings stay until the
//            release, since graphs captured before hold their addresses;
//   flags    LOAM_PEER_MAX words; flags[r] is the last epoch rank r
//            published to this rank;
//   epoch    gathers done, in device memory: the kernels read it and the
//            signal kernel increments it, so a replayed graph moves on.
// Every rank issues the same gathers in the same order (the mesh's
// replicated control flow), so the epochs stay in step.
//
// One gather, epoch e, three kernels on the caller's stream (a kernel
// boundary orders each step for the whole grid):
//   put     copy x into the own mailbox's slot e % 2;
//   signal  one warp: __threadfence_system(), then store e into every rank's
//           flag word for this rank (st.release.sys), then spin with acquire
//           loads until every rank's word here is >= e; store the epoch;
//   pull    every peer's slot e % 2 into out, in rank order (volatile
//           loads, as NCCL reads a peer's buffer), and the own block from x.
// Two slots need one barrier a gather: a rank rewrites slot e % 2 at epoch
// e + 2 (of whichever mailbox), after it saw every flag >= e + 1, and a rank
// publishes e + 1 only after its pull of epoch e has ended (stream order).
// At one rank a gather is the pull alone: x copied into out.
//
// The spin is bounded: past `timeout_cycles` of clock64 it prints the rank
// it waited for and traps, so a rank that never arrives makes the call
// raise (a sticky launch failure) instead of hanging.
//
// Bound: bytes. A rank reads its x and writes the output locally
// (3.35 TB/s on an H100 SXM) while it pulls world - 1 peers' blocks over
// NVLink (450 GB/s a direction); the two overlap. The copies move 16 bytes a thread a step where the addresses
// allow, a byte otherwise (small, odd-sized gathers: flags, counts).

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#define LOAM_PEER_MAX 8
#define LOAM_PEER_THREADS 256
#define LOAM_PEER_BLOCKS 1024
#define LOAM_PEER_GENS 32  // mailboxes a mesh may make (each at least twice the last)

struct PeerPtrs {
  char* mailbox[LOAM_PEER_MAX];
  unsigned long long* flags[LOAM_PEER_MAX];
};

struct LoamPeer {
  int world, rank;
  long long timeout_cycles;
  int gens;                                    // mailboxes made; the last is in use
  size_t cap;                                  // bytes a slot of the one in use
  char* own[LOAM_PEER_GENS];                   // own mailboxes, 2 * their cap
  char* mapped[LOAM_PEER_GENS][LOAM_PEER_MAX];  // the peers' mailboxes opened here
  unsigned long long* flags;                   // own: LOAM_PEER_MAX words
  unsigned long long* epoch;                   // own: gathers done
  PeerPtrs peers;  // every rank's flags and mailbox in use, this rank's own at `rank`
};

__device__ __forceinline__ int4 ld_volatile16(const char* p) {
  int4 v;
  asm volatile("ld.volatile.global.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// n bytes from src to dst, thread `lane` of `lanes`: 16 bytes a step where
// both ends are 16-byte aligned, then the tail (or everything) a byte a step
template <bool kVolatile>
__device__ __forceinline__ void copy_bytes(char* dst, const char* src, size_t n, size_t lane,
                                           size_t lanes) {
  const bool wide = ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0;
  const size_t n16 = wide ? n / 16 : 0;
  for (size_t i = lane; i < n16; i += lanes) {
    int4 v = kVolatile ? ld_volatile16(src + 16 * i) : reinterpret_cast<const int4*>(src)[i];
    reinterpret_cast<int4*>(dst)[i] = v;
  }
  for (size_t i = 16 * n16 + lane; i < n; i += lanes) {
    dst[i] = kVolatile ? *reinterpret_cast<const volatile char*>(src + i) : src[i];
  }
}

__global__ void peer_put_kernel(const char* x, size_t n, char* mailbox, size_t cap,
                                const unsigned long long* epoch) {
  const unsigned long long e = *epoch + 1;
  copy_bytes<false>(mailbox + (e & 1) * cap, x, n, (size_t)blockIdx.x * blockDim.x + threadIdx.x,
                    (size_t)gridDim.x * blockDim.x);
}

__global__ void peer_signal_kernel(PeerPtrs peers, int world, int rank, unsigned long long* epoch,
                                   long long timeout_cycles) {
  const unsigned long long e = *epoch + 1;
  const int t = threadIdx.x;
  if (t < world) {
    // the put kernel's stores ended before this kernel began: the fence
    // makes them visible to every card before the flag says so
    __threadfence_system();
    st_release_sys(peers.flags[t] + rank, e);
    const unsigned long long* mine = peers.flags[rank] + t;
    const long long start = clock64();
    while (ld_acquire_sys(mine) < e) {
      if (clock64() - start > timeout_cycles) {
        printf("peer_gather: rank %d waited past its timeout for rank %d at epoch %llu\n", rank, t, e);
        __trap();
      }
    }
  }
  __syncthreads();
  if (t == 0) *epoch = e;
}

__global__ void peer_pull_kernel(PeerPtrs peers, int rank, const char* x, size_t n, size_t cap,
                                 const unsigned long long* epoch, char* out) {
  const int r = blockIdx.y;
  const size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x, lanes = (size_t)gridDim.x * blockDim.x;
  if (r == rank) {
    copy_bytes<false>(out + (size_t)r * n, x, n, lane, lanes);
  } else {
    const unsigned long long e = *epoch;  // this gather's: the signal kernel stored it
    copy_bytes<true>(out + (size_t)r * n, peers.mailbox[r] + (e & 1) * cap, n, lane, lanes);
  }
}

static unsigned grid_for(size_t n, int ways) {
  size_t steps = (n + 16 * LOAM_PEER_THREADS - 1) / (16 * LOAM_PEER_THREADS);
  size_t most = LOAM_PEER_BLOCKS / ways;
  return (unsigned)(steps < 1 ? 1 : (steps > most ? most : steps));
}

extern "C" int loam_peer_max_ranks() { return LOAM_PEER_MAX; }

// The state of a mesh's rank `rank` of `world` on the current device: flags
// and epoch zeroed, no mailbox yet. Its handle into *out.
extern "C" int loam_peer_create(int world, int rank, double timeout_s, void** out) {
  if (world < 1 || world > LOAM_PEER_MAX || rank < 0 || rank >= world) return (int)cudaErrorInvalidValue;
  int dev, khz;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev);
  if (err != cudaSuccess) return (int)err;
  LoamPeer* s = new LoamPeer;
  memset(s, 0, sizeof(LoamPeer));
  s->world = world;
  s->rank = rank;
  s->timeout_cycles = (long long)(timeout_s * khz * 1e3);
  err = cudaMalloc(&s->flags, LOAM_PEER_MAX * sizeof(unsigned long long));
  if (err == cudaSuccess) err = cudaMalloc(&s->epoch, sizeof(unsigned long long));
  if (err == cudaSuccess) err = cudaMemset(s->flags, 0, LOAM_PEER_MAX * sizeof(unsigned long long));
  if (err == cudaSuccess) err = cudaMemset(s->epoch, 0, sizeof(unsigned long long));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    cudaFree(s->flags);
    cudaFree(s->epoch);
    delete s;
    return (int)err;
  }
  s->peers.flags[rank] = s->flags;
  *out = s;
  return 0;
}

// The PCI bus id of the current device ("0000:00:00.0"), for the ranks to
// name their cards to each other.
extern "C" int loam_peer_bus_id(char* out, int len) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  return (int)(err != cudaSuccess ? err : cudaDeviceGetPCIBusId(out, len, dev));
}

// Whether the cards at PCI bus ids a and b reach each other's memory both
// ways (*ok 1; a card with itself: 1). *ok is -1 where this process does
// not see one of them: cudaIpcOpenMemHandle decides then.
extern "C" int loam_peer_can_reach(const char* a, const char* b, int* ok) {
  int da, db;
  if (cudaDeviceGetByPCIBusId(&da, a) != cudaSuccess || cudaDeviceGetByPCIBusId(&db, b) != cudaSuccess) {
    cudaGetLastError();  // not sticky; clear it
    *ok = -1;
    return 0;
  }
  if (da == db) {
    *ok = 1;
    return 0;
  }
  int ab, ba;
  cudaError_t err = cudaDeviceCanAccessPeer(&ab, da, db);
  if (err == cudaSuccess) err = cudaDeviceCanAccessPeer(&ba, db, da);
  *ok = ab && ba;
  return (int)err;
}

// cudaIpcGetMemHandle of the flags (64 bytes into handle).
extern "C" int loam_peer_flags_handle(void* h, void* handle) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  return (int)cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), s->flags);
}

// A new own mailbox of two slots of `cap` bytes (a multiple of 16), in use
// from now on; its handle into `handle`. The earlier ones stay.
extern "C" int loam_peer_mailbox(void* h, long long cap, void* handle) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  if (cap <= 0 || cap % 16 || s->gens == LOAM_PEER_GENS) return (int)cudaErrorInvalidValue;
  char* box;
  cudaError_t err = cudaMalloc(&box, 2 * (size_t)cap);
  if (err == cudaSuccess) err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), box);
  if (err != cudaSuccess) {
    cudaFree(box);
    return (int)err;
  }
  s->own[s->gens++] = box;
  s->cap = (size_t)cap;
  s->peers.mailbox[s->rank] = box;
  return 0;
}

// After every rank made its new mailbox (the caller's exchange of handles
// orders that): open every peer's, and its flags the first time. `handles`:
// a rank after another, the flags' handle then the mailbox's (2 x 64
// bytes). *failed: the rank whose handle did not open, else -1.
extern "C" int loam_peer_open(void* h, const char* handles, int* failed) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  *failed = -1;
  const size_t hs = sizeof(cudaIpcMemHandle_t);
  for (int r = 0; r < s->world; ++r) {
    if (r == s->rank) continue;
    cudaIpcMemHandle_t flags, box;
    memcpy(&flags, handles + 2 * hs * r, hs);
    memcpy(&box, handles + 2 * hs * r + hs, hs);
    cudaError_t err = cudaSuccess;
    if (!s->peers.flags[r]) {
      void* p = nullptr;
      err = cudaIpcOpenMemHandle(&p, flags, cudaIpcMemLazyEnablePeerAccess);
      s->peers.flags[r] = static_cast<unsigned long long*>(p);
    }
    if (err == cudaSuccess) {
      void* p = nullptr;
      err = cudaIpcOpenMemHandle(&p, box, cudaIpcMemLazyEnablePeerAccess);
      s->mapped[s->gens - 1][r] = s->peers.mailbox[r] = static_cast<char*>(p);
    }
    if (err != cudaSuccess) {
      *failed = r;
      return (int)err;
    }
  }
  return 0;
}

// Close every peer mapping here (first step of a release: the caller then
// waits for every rank to have closed its own before loam_peer_free).
extern "C" int loam_peer_close(void* h) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  cudaError_t first = cudaSuccess;
  for (int r = 0; r < s->world; ++r) {
    if (r == s->rank) continue;
    for (int g = 0; g < s->gens; ++g) {
      if (!s->mapped[g][r]) continue;
      cudaError_t err = cudaIpcCloseMemHandle(s->mapped[g][r]);
      if (first == cudaSuccess) first = err;
      s->mapped[g][r] = nullptr;
    }
    s->peers.mailbox[r] = nullptr;
    if (!s->peers.flags[r]) continue;
    cudaError_t err = cudaIpcCloseMemHandle(s->peers.flags[r]);
    if (first == cudaSuccess) first = err;
    s->peers.flags[r] = nullptr;
  }
  return (int)first;
}

// Free the own buffers and the state.
extern "C" int loam_peer_free(void* h) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  cudaError_t first = cudaSuccess;
  for (int g = 0; g < s->gens; ++g) {
    cudaError_t err = cudaFree(s->own[g]);
    if (first == cudaSuccess) first = err;
  }
  void* own[2] = {s->flags, s->epoch};
  for (void* p : own) {
    if (!p) continue;
    cudaError_t err = cudaFree(p);
    if (first == cudaSuccess) first = err;
  }
  delete s;
  return (int)first;
}

// One gather of `n` bytes a rank: x (n bytes) -> out (world * n bytes).
extern "C" int loam_peer_gather(void* h, const void* x, void* out, long long n, cudaStream_t stream) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  if (n < 0 || (s->world > 1 && (size_t)n > s->cap)) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)n;
  const char* src = static_cast<const char*>(x);
  if (s->world > 1) {
    peer_put_kernel<<<grid_for(bytes, 1), LOAM_PEER_THREADS, 0, stream>>>(src, bytes, s->peers.mailbox[s->rank],
                                                                         s->cap, s->epoch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    peer_signal_kernel<<<1, 32, 0, stream>>>(s->peers, s->world, s->rank, s->epoch, s->timeout_cycles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  peer_pull_kernel<<<dim3(grid_for(bytes, s->world), s->world), LOAM_PEER_THREADS, 0, stream>>>(
      s->peers, s->rank, src, bytes, s->cap, s->epoch, static_cast<char*>(out));
  return (int)cudaGetLastError();
}
