// The mesh's collectives over peer memory, one kernel launch each:
//   gather  every rank's bytes of a list of segments (the leaves of a tree
//           of tensors), each segment concatenated in rank order on every
//           rank, as dist.all_gather_into_tensor gives them leaf by leaf;
//   sum     every shard's block of a per-shard tensor (L blocks a rank)
//           added elementwise in global shard order, one IEEE add after
//           another (no FMA), as `out = parts[0].clone(); out += part` over
//           the gathered blocks does, without making the gathered buffer:
//           rank q adds up slice q of the block (a reduce-scatter) and
//           sends its sums to every peer (an all-gather), each element's
//           adds in the same order as ever
// (loam_tpu_torch/ops/peer_cuda.py, parallel/collectives.py).
//
// It replaces no Pallas kernel: loam_tpu leaves its collectives to XLA
// (the sharded kNN's all-gather, distributed.py:83; the insert's psum,
// :190; the pose graph's psum of H, b and the cost, pose_graph.py:281-283),
// which places them inside its jitted while loops and conds. NCCL 2.28.9
// refuses a collective captured inside a CUDA-graph WHILE or IF body past
// one rank, so the port gathers and sums with this kernel, which a graph
// captures anywhere: no host read, no host copy, and every argument fixed
// at the capture (a replay runs its nodes with the arguments of the
// capture).
//
// State, per mesh and rank, made with cudaMalloc and shared with the other
// ranks through cudaIpcGetMemHandle / cudaIpcOpenMemHandle:
//   mailbox  two slots of `world` regions of `cap` bytes; in gather or sum
//            e, rank q pushes its payload into region q of slot e % 2 of
//            every peer (a gather: its packed leaves; a sum: the peer's
//            slice of its L blocks, then its own slice's sums, (L + 1) x
//            a block / world bytes). A larger mailbox is made where a
//            payload outgrows `cap` (every rank at the same collective);
//            the earlier ones and their mappings stay until the release,
//            since graphs captured before hold their addresses. A rank's
//            mailbox holds 2 x world x cap bytes: for the sum of the pose
//            graph's H at 4 ranks (288 MB a rank, 144 MB a region) 1.15
//            GB; for a gather of it 2.3 GB;
//   control  flags[s][k]: the last epoch sender s pushed chunk k here;
//            acks[t]: the last epoch rank t finished reading its mailbox;
//            the epoch (collectives done) and a ticket, both in device
//            memory: the kernel reads the epoch and its last block steps
//            it, so a replayed graph moves on.
// Every rank issues the same collectives in the same order (the mesh's
// replicated control flow), so the epochs stay in step.
//
// One collective, epoch e, one kernel on the caller's stream. Its payload
// (the segments packed at 16-byte offsets; in a sum the range of a block)
// is cut into chunks, a block a chunk up to what the card holds at once.
// Block b takes chunks k = b, b + G, ... and, for each, pushes it and then
// receives the one before (which the peers' blocks b pushed a step
// earlier, so the wait overlaps this block's push):
//   push     once, wait until every peer t acknowledged epoch e - 2 (the
//            credit to rewrite slot e % 2; in steady state it is there);
//            then copy chunk k from the source into region `rank` of every
//            peer's slot e % 2 over NVLink (stores, 16 bytes a thread and
//            four in flight), and in a gather into the rank's own output;
//            then a barrier, and one thread a peer stores e into that
//            peer's flags[rank][k] with a release at system scope (the
//            barrier and the release order the block's stores before it);
//   receive  gather: for each peer s, one thread waits with acquire loads
//            until flags[s][k] >= e, then the block copies that chunk of
//            region s of its own mailbox into the output at the memory's
//            rate (L2-only loads). Sum: once every peer's flag of chunk k
//            is up, each element of the own slice's chunk added over the
//            shards in global order (the own blocks read from the input)
//            and stored into the output and every peer's region `rank`,
//            with a second flag; a step later, each peer's sums of chunk k
//            copied into the output as their flags come.
// Then each block takes a ticket; the last one stores the epoch and
// acknowledges e to every peer (release, system scope). A sender rewrites a
// peer's slot e % 2 at e + 2 only after that peer's ack of e, so no rank
// writes a region a peer still reads (a rank runs two collectives ahead of
// a peer only past one that moves nothing, which waits for no one; the
// protocol is modelled in tests/test_torch_peer_gather.py); flags only
// grow, and a flag >= e means chunk k of epoch e is in place (a later
// epoch's flag follows the whole earlier kernel). The grid never exceeds
// what the card holds at once, so every block of a rank runs while it
// waits.
//
// At one rank no mailbox, no flag: a gather is one copy kernel, a sum reads
// the L blocks and writes one. A spin is bounded: past `timeout_cycles` of
// clock64 it prints what it waited for and traps, so a rank that never
// arrives makes the call raise (a sticky launch failure) instead of
// hanging.
//
// Bound: bytes. Gather: the larger of the peers' blocks over NVLink (450
// GB/s a direction on an H100 SXM) and the rank's own block read and the
// output written at 3.35 TB/s; sum: the larger of what the reduce-scatter
// and the all-gather move over NVLink, 2 (world - 1) / world blocks (L of
// them in the first), and every shard's slice read and the block written.
// The sum sends each peer a quarter of a block at 4 ranks twice, where
// pushing every block to every peer would send it whole: half the bytes.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#define LOAM_PEER_MAX 8
#define LOAM_PEER_THREADS 512
#define LOAM_PEER_GENS 32        // mailboxes a mesh may make (each at least twice the last)
#define LOAM_PEER_SEGS 64        // segments (leaves) of one gather
#define LOAM_PEER_CHUNKS 4096    // flags a sender; a sum's two phases take half each
#define LOAM_PEER_CHUNK_MIN (4 << 10)   // a chunk's bytes: at least this,
#define LOAM_PEER_CHUNK_MAX (64 << 10)  // and at most this unless the flags run out
#define LOAM_PEER_UNROLL 8       // 16-byte loads in flight a thread (a copy to one place)

enum { kGather = 0, kSum = 1 };
enum { kF32 = 0, kF64 = 1, kI32 = 2, kI64 = 3 };

struct Control {
  unsigned long long flags[LOAM_PEER_MAX][LOAM_PEER_CHUNKS];
  unsigned long long acks[LOAM_PEER_MAX];
  unsigned long long epoch;
  unsigned int ticket;
};

struct Segment {
  const char* src;
  char* dst;
  unsigned long long off;  // in the packed payload, a multiple of 16
  unsigned long long n;    // bytes a rank
};

struct Job {
  char* mailbox[LOAM_PEER_MAX];   // every rank's mailbox in use, this rank's own at `rank`
  Control* ctl[LOAM_PEER_MAX];    // every rank's control words
  int world, rank, mode, dtype, nseg, chunks;
  unsigned long long cap;         // bytes a region
  unsigned long long total;       // gather: packed bytes a rank; sum: bytes a block
  unsigned long long slice;       // sum: bytes of a block a rank adds up (a multiple of 16)
  unsigned long long chunk;       // bytes a chunk (of the payload; of a slice)
  unsigned long long L;           // sum: blocks a rank
  long long timeout_cycles;
  Segment seg[LOAM_PEER_SEGS];    // sum: seg[0] is the input (L blocks) and the output
};

struct LoamPeer {
  int world, rank, grid_max;
  long long timeout_cycles;
  int gens;                                    // mailboxes made; the last is in use
  size_t cap;                                  // bytes a region of the one in use
  char* own[LOAM_PEER_GENS];                   // own mailboxes, 2 * world * their cap
  char* mapped[LOAM_PEER_GENS][LOAM_PEER_MAX];  // the peers' mailboxes opened here
  Control* ctl;                                // own
  char* mailbox[LOAM_PEER_MAX];
  Control* ctls[LOAM_PEER_MAX];
};

__device__ __forceinline__ void st_release_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// thread 0 spins until *p >= want (acquire, system scope), then the block
// goes on; past the timeout it names what it waited for and traps
__device__ void wait_at_least(const unsigned long long* p, unsigned long long want, const Job& job,
                              const char* what, int who, int chunk) {
  if (threadIdx.x == 0) {
    const long long start = clock64();
    while (ld_acquire_sys(p) < want) {
      if (clock64() - start > job.timeout_cycles) {
        printf("peer collective: rank %d waited past its timeout for rank %d's %s (chunk %d) at epoch %llu\n",
               job.rank, who, what, chunk, want);
        __trap();
      }
    }
  }
  __syncthreads();
}

// after the block's stores: flag `slot` of this rank raised to e at every peer
__device__ __forceinline__ void raise_flags(const Job& job, int slot, unsigned long long e) {
  __syncthreads();  // the block's stores, then the flags
  const int t = threadIdx.x;
  if (t < job.world && t != job.rank) st_release_sys(&job.ctl[t]->flags[job.rank][slot], e);
}

template <typename V>
__device__ __forceinline__ V load(const V* p, bool l2) {
  return l2 ? __ldcg(p) : *p;
}

// n bytes from src to each of dst[0..nd) (nd <= ND), the block's threads:
// V-wide units (every address V-aligned), U loads in flight a thread, then
// the tail a byte a thread
template <typename V, int U, int ND>
__device__ void copy_units(const char* src, char* const* dst, int nd, size_t n, bool l2) {
  const size_t units = n / sizeof(V), lanes = blockDim.x;
  const V* s = reinterpret_cast<const V*>(src);
  size_t i = threadIdx.x;
  for (; i + (U - 1) * lanes < units; i += U * lanes) {
    V v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = load(s + i + u * lanes, l2);
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      if (d >= nd) break;
#pragma unroll
      for (int u = 0; u < U; ++u) reinterpret_cast<V*>(dst[d])[i + u * lanes] = v[u];
    }
  }
  for (; i < units; i += lanes) {
    const V v = load(s + i, l2);
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      if (d >= nd) break;
      reinterpret_cast<V*>(dst[d])[i] = v;
    }
  }
  for (size_t t = units * sizeof(V) + threadIdx.x; t < n; t += lanes) {
    const char c = load(reinterpret_cast<const unsigned char*>(src) + t, l2);
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      if (d >= nd) break;
      dst[d][t] = c;
    }
  }
}

template <typename V>
__device__ void copy_to(const char* src, char* const* dst, int nd, size_t n, bool l2) {
  // one destination (a copy out of the mailbox, a rank's own block) keeps
  // LOAM_PEER_UNROLL loads in flight; several (the pushes) half as many, to
  // stay in the registers
  if (nd == 1) copy_units<V, LOAM_PEER_UNROLL, 1>(src, dst, 1, n, l2);
  else copy_units<V, LOAM_PEER_UNROLL / 2, LOAM_PEER_MAX>(src, dst, nd, n, l2);
}

// the widest unit every end is aligned to
__device__ void copy(const char* src, char* const* dst, int nd, size_t n, bool l2) {
  uintptr_t a = reinterpret_cast<uintptr_t>(src);
  for (int d = 0; d < nd; ++d) a |= reinterpret_cast<uintptr_t>(dst[d]);
  if (!(a & 15)) copy_to<int4>(src, dst, nd, n, l2);
  else if (!(a & 7)) copy_to<uint2>(src, dst, nd, n, l2);
  else if (!(a & 3)) copy_to<unsigned>(src, dst, nd, n, l2);
  else copy_to<unsigned char>(src, dst, nd, n, l2);
}

__device__ __forceinline__ char* region(const Job& job, int owner, int sender, unsigned long long e) {
  return job.mailbox[owner] + ((e & 1) * job.world + sender) * job.cap;
}

// ---- gather ----

// chunk k of the packed payload, segment by segment, from the input (push:
// into every peer's region `rank` and the own output) or from region
// `from` of the own mailbox (receive: into sender `from`'s output)
__device__ void gather_chunk(const Job& job, int k, unsigned long long e, int from) {
  const unsigned long long lo = (unsigned long long)k * job.chunk;
  const unsigned long long hi = min(lo + job.chunk, job.total);
  const bool push = from < 0;
  for (int i = 0; i < job.nseg; ++i) {
    const Segment& s = job.seg[i];
    const unsigned long long a = max(lo, s.off), b = min(hi, s.off + s.n);
    if (a >= b) continue;
    char* dst[LOAM_PEER_MAX];
    int nd = 0;
    if (push) {
      for (int t = 0; t < job.world; ++t)
        if (t != job.rank) dst[nd++] = region(job, t, job.rank, e) + a;
      dst[nd++] = s.dst + job.rank * s.n + (a - s.off);
      copy(s.src + (a - s.off), dst, nd, b - a, false);
    } else {
      dst[nd++] = s.dst + from * s.n + (a - s.off);
      copy(region(job, job.rank, from, e) + a, dst, nd, b - a, true);
    }
  }
}

// ---- sum: a reduce-scatter and an all-gather in one kernel ----
// Rank q adds up slice q of the block (bytes [q S, (q + 1) S), cut at the
// block's end) over every shard in global order and sends the sums to every
// peer. A sender's region holds the slices it sends: its L blocks' slice of
// the owner (L S bytes), then its own slice's sums (S bytes); chunk k of a
// slice is bytes [k C, (k + 1) C) of it. Flag k says phase one's chunk k is
// in place, flag LOAM_PEER_CHUNKS / 2 + k phase two's.

__device__ __forceinline__ unsigned long long slice_bytes(const Job& job, int q) {
  const unsigned long long lo = q * job.slice;
  return lo >= job.total ? 0 : min(job.slice, job.total - lo);
}

// bytes of chunk k of slice q
__device__ __forceinline__ unsigned long long chunk_bytes(const Job& job, int q, int k) {
  const unsigned long long n = slice_bytes(job, q), lo = (unsigned long long)k * job.chunk;
  return lo >= n ? 0 : min(job.chunk, n - lo);
}

// phase one, push: chunk k of each peer's slice of the L blocks into its region `rank`
__device__ void sum_push(const Job& job, int k, unsigned long long e) {
  const unsigned long long lo = (unsigned long long)k * job.chunk;
  for (int t = 0; t < job.world; ++t) {
    const unsigned long long n = chunk_bytes(job, t, k);
    if (t == job.rank || n == 0) continue;
    char* base = region(job, t, job.rank, e);
    for (unsigned long long j = 0; j < job.L; ++j) {
      char* dst = base + j * job.slice + lo;
      copy(job.seg[0].src + j * job.total + t * job.slice + lo, &dst, 1, n, false);
    }
  }
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
// integers wrap, as PyTorch's do
__device__ __forceinline__ int add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ long long add(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

// the V-th unit `at` of chunk k of the own slice in global shard g's block
template <typename V>
__device__ __forceinline__ V shard_unit(const Job& job, unsigned long long g, unsigned long long lo,
                                        unsigned long long at, unsigned long long e) {
  const int q = (int)(g / job.L);
  const unsigned long long j = g % job.L;
  if (q == job.rank)
    return load(reinterpret_cast<const V*>(job.seg[0].src + j * job.total + job.rank * job.slice + lo) + at, false);
  return load(reinterpret_cast<const V*>(region(job, job.rank, q, e) + j * job.slice + lo) + at, true);
}

// phase one, receive, and phase two, push: chunk k of the own slice (n
// bytes at lo) added over every shard in global order, two units a thread
// at a time, into the output and every peer's region `rank`; V holds W
// elements of T
template <typename T, typename V, int W>
__device__ void sum_units(const Job& job, unsigned long long e, unsigned long long lo, unsigned long long n,
                          char* const* dst, int nd) {
  const unsigned long long shards = job.world * job.L, units = n / sizeof(V), lanes = blockDim.x;
  for (unsigned long long i = threadIdx.x; i < units; i += 2 * lanes) {
    const bool two = i + lanes < units;
    V acc[2];
    acc[0] = shard_unit<V>(job, 0, lo, i, e);
    if (two) acc[1] = shard_unit<V>(job, 0, lo, i + lanes, e);
    for (unsigned long long g = 1; g < shards; ++g) {
      V v[2];
      v[0] = shard_unit<V>(job, g, lo, i, e);
      if (two) v[1] = shard_unit<V>(job, g, lo, i + lanes, e);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        T* a = reinterpret_cast<T*>(&acc[u]);
        const T* b = reinterpret_cast<const T*>(&v[u]);
#pragma unroll
        for (int w = 0; w < W; ++w) a[w] = add(a[w], b[w]);
      }
    }
#pragma unroll
    for (int d = 0; d < LOAM_PEER_MAX; ++d) {
      if (d >= nd) break;
      reinterpret_cast<V*>(dst[d])[i] = acc[0];
      if (two) reinterpret_cast<V*>(dst[d])[i + lanes] = acc[1];
    }
  }
}

template <typename T, typename V>
__device__ void sum_typed(const Job& job, unsigned long long e, unsigned long long lo, unsigned long long n,
                          char* const* dst, int nd) {
  uintptr_t a = reinterpret_cast<uintptr_t>(job.seg[0].src) | job.total | job.cap;
  for (int d = 0; d < nd; ++d) a |= reinterpret_cast<uintptr_t>(dst[d]);
  if (!(a & 15)) sum_units<T, V, sizeof(V) / sizeof(T)>(job, e, lo, n, dst, nd);
  else sum_units<T, T, 1>(job, e, lo, n, dst, nd);
}

// phase one's receive and phase two's push of chunk k of the own slice
__device__ void sum_own(const Job& job, int k, unsigned long long e) {
  const int me = job.rank;
  const unsigned long long n = chunk_bytes(job, me, k), lo = (unsigned long long)k * job.chunk;
  for (int s = 0; s < job.world; ++s)
    if (s != me) wait_at_least(&job.ctl[me]->flags[s][k], e, job, "slice chunk", s, k);
  if (n > 0) {
    char* dst[LOAM_PEER_MAX];
    int nd = 0;
    dst[nd++] = job.seg[0].dst + me * job.slice + lo;
    for (int t = 0; t < job.world; ++t)
      if (t != me) dst[nd++] = region(job, t, me, e) + job.L * job.slice + lo;
    switch (job.dtype) {
      case kF32: sum_typed<float, float4>(job, e, lo, n, dst, nd); break;
      case kF64: sum_typed<double, double2>(job, e, lo, n, dst, nd); break;
      case kI32: sum_typed<int, int4>(job, e, lo, n, dst, nd); break;
      default: sum_typed<long long, longlong2>(job, e, lo, n, dst, nd); break;
    }
  }
  if (job.world > 1) raise_flags(job, LOAM_PEER_CHUNKS / 2 + k, e);
}

// phase two, receive: chunk k of every peer's slice of sums into the output
__device__ void sum_collect(const Job& job, int k, unsigned long long e) {
  const unsigned long long lo = (unsigned long long)k * job.chunk;
  for (int q = 0; q < job.world; ++q) {
    if (q == job.rank) continue;
    wait_at_least(&job.ctl[job.rank]->flags[q][LOAM_PEER_CHUNKS / 2 + k], e, job, "sums chunk", q, k);
    const unsigned long long n = chunk_bytes(job, q, k);
    if (n == 0) continue;
    char* dst = job.seg[0].dst + q * job.slice + lo;
    copy(region(job, job.rank, q, e) + job.L * job.slice + lo, &dst, 1, n, true);
  }
}

__global__ void __launch_bounds__(LOAM_PEER_THREADS) peer_kernel(const __grid_constant__ Job job) {
  const int G = gridDim.x, me = job.rank, w = job.world;
  Control* ctl = job.ctl[me];
  const unsigned long long e = w > 1 ? *reinterpret_cast<volatile unsigned long long*>(&ctl->epoch) + 1 : 0;

  // chunks k = b, b + G, ... as a pipeline: step i pushes chunk k_i, and
  // receives what the peers' blocks b pushed a step earlier (a gather's
  // k_(i-1); a sum's phase one of k_(i-1), whose sums it pushes, and phase
  // two of k_(i-2))
  const int lag = job.mode == kSum && w > 1 ? 2 : 1;
  for (int i = 0;; ++i) {
    const int k = blockIdx.x + i * G;
    if (k >= job.chunks + lag * G) break;
    if (k < job.chunks && w > 1) {
      if (i == 0 && e > 2) {
        for (int t = 0; t < w; ++t)
          if (t != me) wait_at_least(&ctl->acks[t], e - 2, job, "acknowledgement", t, -1);
      }
      if (job.mode == kGather) gather_chunk(job, k, e, -1);
      else sum_push(job, k, e);
      raise_flags(job, k, e);
    } else if (k < job.chunks && job.mode == kGather) {
      gather_chunk(job, k, e, -1);  // one rank: the copy
    }
    const int k1 = k - G, k2 = k - 2 * G;
    if (job.mode == kGather) {
      if (w > 1 && k1 >= 0 && k1 < job.chunks)
        for (int s = 0; s < w; ++s) {
          if (s == me) continue;
          wait_at_least(&ctl->flags[s][k1], e, job, "chunk", s, k1);
          gather_chunk(job, k1, e, s);
        }
    } else {
      if (k1 >= 0 && k1 < job.chunks) sum_own(job, k1, e);
      if (w > 1 && k2 >= 0 && k2 < job.chunks) sum_collect(job, k2, e);
    }
  }
  if (w == 1) return;
  // the last block out: the epoch, and the acknowledgement to every peer
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&ctl->ticket, 1u) == (unsigned)G - 1) {
      ctl->ticket = 0;
      ctl->epoch = e;
      for (int t = 0; t < w; ++t)
        if (t != me) st_release_sys(&job.ctl[t]->acks[me], e);
    }
  }
}

extern "C" int loam_peer_max_ranks() { return LOAM_PEER_MAX; }
extern "C" int loam_peer_max_segments() { return LOAM_PEER_SEGS; }

// The state of a mesh's rank `rank` of `world` on the current device:
// control words zeroed, no mailbox yet. Its handle into *out.
extern "C" int loam_peer_create(int world, int rank, double timeout_s, void** out) {
  if (world < 1 || world > LOAM_PEER_MAX || rank < 0 || rank >= world) return (int)cudaErrorInvalidValue;
  int dev, khz, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, peer_kernel, LOAM_PEER_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  LoamPeer* s = new LoamPeer;
  memset(s, 0, sizeof(LoamPeer));
  s->world = world;
  s->rank = rank;
  s->timeout_cycles = (long long)(timeout_s * khz * 1e3);
  // every block of a grid resident at once: a block that waits never keeps
  // another, whose chunks a peer waits for, off the card
  s->grid_max = sms * per_sm;
  err = cudaMalloc(&s->ctl, sizeof(Control));
  if (err == cudaSuccess) err = cudaMemset(s->ctl, 0, sizeof(Control));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err != cudaSuccess || s->grid_max < 1) {
    cudaFree(s->ctl);
    delete s;
    return (int)(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
  }
  s->ctls[rank] = s->ctl;
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

// cudaIpcGetMemHandle of the control words (64 bytes into handle).
extern "C" int loam_peer_flags_handle(void* h, void* handle) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  return (int)cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), s->ctl);
}

// A new own mailbox of two slots of `world` regions of `cap` bytes (a
// multiple of 16), in use from now on; its handle into `handle`. The
// earlier ones stay.
extern "C" int loam_peer_mailbox(void* h, long long cap, void* handle) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  if (cap <= 0 || cap % 16 || s->gens == LOAM_PEER_GENS) return (int)cudaErrorInvalidValue;
  char* box;
  cudaError_t err = cudaMalloc(&box, 2 * (size_t)s->world * (size_t)cap);
  if (err == cudaSuccess) err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), box);
  if (err != cudaSuccess) {
    cudaFree(box);
    return (int)err;
  }
  s->own[s->gens++] = box;
  s->cap = (size_t)cap;
  s->mailbox[s->rank] = box;
  return 0;
}

// After every rank made its new mailbox (the caller's exchange of handles
// orders that): open every peer's, and its control words the first time.
// `handles`: a rank after another, the control words' handle then the
// mailbox's (2 x 64 bytes). *failed: the rank whose handle did not open,
// else -1.
extern "C" int loam_peer_open(void* h, const char* handles, int* failed) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  *failed = -1;
  const size_t hs = sizeof(cudaIpcMemHandle_t);
  for (int r = 0; r < s->world; ++r) {
    if (r == s->rank) continue;
    cudaIpcMemHandle_t ctl, box;
    memcpy(&ctl, handles + 2 * hs * r, hs);
    memcpy(&box, handles + 2 * hs * r + hs, hs);
    cudaError_t err = cudaSuccess;
    if (!s->ctls[r]) {
      void* p = nullptr;
      err = cudaIpcOpenMemHandle(&p, ctl, cudaIpcMemLazyEnablePeerAccess);
      s->ctls[r] = static_cast<Control*>(p);
    }
    if (err == cudaSuccess) {
      void* p = nullptr;
      err = cudaIpcOpenMemHandle(&p, box, cudaIpcMemLazyEnablePeerAccess);
      s->mapped[s->gens - 1][r] = s->mailbox[r] = static_cast<char*>(p);
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
    s->mailbox[r] = nullptr;
    if (!s->ctls[r]) continue;
    cudaError_t err = cudaIpcCloseMemHandle(s->ctls[r]);
    if (first == cudaSuccess) first = err;
    s->ctls[r] = nullptr;
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
  if (s->ctl) {
    cudaError_t err = cudaFree(s->ctl);
    if (first == cudaSuccess) first = err;
  }
  delete s;
  return (int)first;
}

// One collective. `segs`: nseg x (src, dst, packed offset, bytes a rank)
// (a sum: one, its input of L blocks and its output). Gather: `total` the
// packed bytes a rank; sum: `total` a block's bytes, `L` the blocks a
// rank, `dtype` kF32..kI64.
extern "C" int loam_peer_run(void* h, const long long* segs, int nseg, int mode, int dtype, long long total,
                             long long L, cudaStream_t stream) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  if (nseg < 1 || nseg > LOAM_PEER_SEGS || total < 0 || (mode == kSum && (nseg != 1 || L < 1)) ||
      dtype < kF32 || dtype > kI64)
    return (int)cudaErrorInvalidValue;
  // a sum's slice: a block's bytes over the ranks, a multiple of 16
  const unsigned long long slice = (((unsigned long long)total + s->world - 1) / s->world + 15) / 16 * 16;
  const unsigned long long payload = mode == kGather ? (unsigned long long)total : (unsigned long long)(L + 1) * slice;
  if (s->world > 1 && payload > s->cap) return (int)cudaErrorInvalidValue;
  Job job;
  memset(&job, 0, sizeof(Job));
  for (int r = 0; r < s->world; ++r) {
    job.mailbox[r] = s->mailbox[r];
    job.ctl[r] = s->ctls[r];
  }
  job.world = s->world;
  job.rank = s->rank;
  job.mode = mode;
  job.dtype = dtype;
  job.nseg = nseg;
  job.cap = s->cap;
  job.total = (unsigned long long)total;
  job.L = (unsigned long long)(mode == kSum ? L : 1);
  job.timeout_cycles = s->timeout_cycles;
  for (int i = 0; i < nseg; ++i) {
    job.seg[i].src = reinterpret_cast<const char*>(segs[4 * i]);
    job.seg[i].dst = reinterpret_cast<char*>(segs[4 * i + 1]);
    job.seg[i].off = (unsigned long long)segs[4 * i + 2];
    job.seg[i].n = (unsigned long long)segs[4 * i + 3];
  }
  job.slice = slice;
  // chunks of the payload (a gather) or of a slice (a sum): enough to give
  // every block of the card one, of 4 to 64 KB, but never more than the
  // flags (a sum: half of them a phase); a multiple of 16
  const unsigned long long space = mode == kGather ? job.total : slice;
  const unsigned long long flags = mode == kGather ? LOAM_PEER_CHUNKS : LOAM_PEER_CHUNKS / 2;
  const auto up16 = [](unsigned long long n) { return (n + 15) / 16 * 16; };
  unsigned long long chunk = up16((space + s->grid_max - 1) / s->grid_max);
  chunk = chunk > LOAM_PEER_CHUNK_MAX ? LOAM_PEER_CHUNK_MAX : chunk;
  chunk = chunk < LOAM_PEER_CHUNK_MIN ? LOAM_PEER_CHUNK_MIN : chunk;
  const unsigned long long fewest = up16((space + flags - 1) / flags);
  job.chunk = chunk < fewest ? fewest : chunk;
  job.chunks = (int)((space + job.chunk - 1) / job.chunk);
  // a block a chunk, at most what the card holds at once; nothing to move
  // (every leaf empty) is still one launch of one block, so the epochs stay
  // in step
  const int g = job.chunks < 1 ? 1 : (job.chunks > s->grid_max ? s->grid_max : job.chunks);
  peer_kernel<<<g, LOAM_PEER_THREADS, 0, stream>>>(job);
  return (int)cudaGetLastError();
}
