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
// (loam_tpu_torch/ops/peer_cuda.py, parallel/collectives.py), to the ranks
// of one host over NVLink and to other hosts through a host proxy over TCP
// (peer_link.h, peer_proxy.cpp).
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
// A rank's peers are on its island (the ranks of its host whose cards reach
// each other's memory) or remote (every other rank: another host, or a card
// this one cannot reach). Each collective reaches every peer through a
// Route: where this rank pushes its region for the peer and raises the
// peer's flags and acknowledgement, where the peer's region for this rank
// lands and its flags and acknowledgement arrive. The kernel's pushes,
// waits and copies are the same for both kinds; only the memory differs.
//
// State, per mesh and rank:
//   mailbox  (island) device memory, cudaMalloc, shared with the island
//            through cudaIpcGetMemHandle / cudaIpcOpenMemHandle: two slots
//            of one region of `cap` bytes an island member; in gather or
//            sum e, rank q pushes its payload into its region of slot e % 2
//            of every island peer over NVLink (a gather: its packed leaves;
//            a sum: the peer's slice of its L blocks, then its own slice's
//            sums, (L + 1) x a block / world bytes). A larger mailbox is
//            made where a payload outgrows `cap` (every rank at the same
//            collective); the earlier ones and their mappings stay until
//            the release, since graphs captured before hold their
//            addresses. For the sum of the pose graph's H at 4 ranks on one
//            host (288 MB a rank, 144 MB a region) 1.15 GB a rank; for a
//            gather of it 2.3 GB;
//   staging  (remote) pinned host memory mapped for the card (cudaHostAlloc),
//            for each remote peer two slots of `cap` bytes out and two in,
//            a generation with each mailbox; the words of peer_link.h (flags
//            and chunk descriptions a slot, acknowledgements) beside it. The
//            kernel stores a chunk into the out staging over PCIe, writes
//            where it lies and raises its flag (release, system scope); the
//            rank's proxy (peer_proxy.cpp) sends it over TCP to the
//            peer's proxy, each run of consecutive raised chunks one
//            message, which lands it in that rank's in staging and
//            raises the flags there; the peer's kernel waits on it (acquire,
//            system scope, with a growing __nanosleep between reads, so the
//            spin does not flood PCIe) and copies the chunk in (L2-only
//            loads, never L1). Acknowledgements cross the same way. A rank
//            holds 4 x cap pinned bytes a remote peer and generation;
//   control  (device) flags[s][k]: the last epoch island sender s pushed
//            chunk k here; acks[t]: the last epoch island rank t finished
//            reading its mailbox; the epoch (collectives done) and a
//            ticket: the kernel reads the epoch and its last block steps
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
//            then copy chunk k from the source into this rank's region of
//            every peer's slot e % 2 (an island peer's mailbox over NVLink,
//            a remote peer's out staging over PCIe; stores, 16 bytes a
//            thread and four in flight), and in a gather into the rank's
//            own output; then a barrier, and one thread a peer raises that
//            peer's flag of chunk k to e with a release at system scope
//            (the barrier and the release order the block's stores before
//            it; a remote peer's chunk description first);
//   receive  gather: for each peer s, one thread waits with acquire loads
//            until s's flag of chunk k is >= e, then the block copies that
//            chunk of s's region into the output at the memory's rate
//            (L2-only loads). Sum: once every peer's flag of chunk k
//            is up, each element of the own slice's chunk added over the
//            shards in global order (the own blocks read from the input)
//            and stored into the output and this rank's region of every peer,
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
// hanging; where a proxy lost its socket it raised the abort word, which
// every spin of a rank with remote peers reads, and the kernel traps at
// once.
//
// Bound: bytes. Gather: the larger of the island peers' blocks over NVLink
// (450 GB/s a direction on an H100 SXM), the remote peers' blocks over PCIe
// (64 GB/s a direction: staged out, then in) and the rank's own block read
// and the output written at 3.35 TB/s; sum: the larger of what the reduce-scatter
// and the all-gather move over NVLink, 2 (world - 1) / world blocks (L of
// them in the first), and every shard's slice read and the block written.
// The sum sends each peer a quarter of a block at 4 ranks twice, where
// pushing every block to every peer would send it whole: half the bytes.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include "peer_link.h"

#define LOAM_PEER_MAX 16
#define LOAM_PEER_THREADS 512
#define LOAM_PEER_SEGS 64        // segments (leaves) of one gather
#define LOAM_PEER_CHUNK_MIN (4 << 10)   // a chunk's bytes: at least this,
#define LOAM_PEER_CHUNK_MAX (64 << 10)  // and at most this unless the flags run out
#define LOAM_PEER_UNROLL 8       // 16-byte loads in flight a thread (a copy to one place)
#define LOAM_PEER_NAP_MAX 4096   // ns: the longest nap between two reads of a remote flag

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

// how this rank reaches one peer (module comment)
struct Route {
  char* push;                           // slot 0 of this rank's region for the peer; slot 1 at + stride
  const char* recv;                     // slot 0 of the peer's region for this rank; slot 1 at + stride
  unsigned long long stride;            // bytes from slot 0 to slot 1
  unsigned long long* push_flags;       // the peer's flag of chunk k, slot s: [s * flag_stride + k]
  const unsigned long long* recv_flags;  // the same of the peer's chunks here
  unsigned long long* desc;             // remote: out_desc, 4 words a slot and chunk; island: null
  unsigned long long* ack_to;           // this rank's acknowledgement, for the peer
  const unsigned long long* ack_from;   // the peer's acknowledgement, here
  int flag_stride;                      // island 0 (a flag a chunk), remote LOAM_PEER_CHUNKS (a slot)
  int remote;
};

struct Job {
  Route route[LOAM_PEER_MAX];     // route[rank] unused
  Control* ctl;                   // this rank's: the epoch and the ticket
  const unsigned long long* abort_word;  // raised by the proxy; null without a remote peer
  int world, rank, mode, dtype, nseg, chunks;
  unsigned long long gen;         // the mailbox generation in use
  unsigned long long total;       // gather: packed bytes a rank; sum: bytes a block
  unsigned long long slice;       // sum: bytes of a block a rank adds up (a multiple of 16)
  unsigned long long chunk;       // bytes a chunk (of the payload; of a slice)
  unsigned long long L;           // sum: blocks a rank
  long long timeout_cycles;
  Segment seg[LOAM_PEER_SEGS];    // sum: seg[0] is the input (L blocks) and the output
};
static_assert(sizeof(Job) <= 4096, "a kernel's arguments fit in 4 KB");

struct LoamPeer {
  int world, rank, grid_max;
  long long timeout_cycles;
  int gens;                                    // mailboxes made; the last is in use
  size_t cap;                                  // bytes a region of the one in use
  int island[LOAM_PEER_MAX];                   // 1: on this rank's island (itself too)
  int pos[LOAM_PEER_MAX];                      // an island member's region in the mailboxes
  int isl_n;                                   // the island's members
  char* own[LOAM_PEER_GENS];                   // own mailboxes, 2 * isl_n * their cap (none alone)
  char* mapped[LOAM_PEER_GENS][LOAM_PEER_MAX];  // the island peers' mailboxes opened here
  Control* ctl;                                // own
  char* mailbox[LOAM_PEER_MAX];                // the island's mailboxes in use
  Control* ctls[LOAM_PEER_MAX];                // the island's control words
  LoamLink* link[LOAM_PEER_MAX];               // a remote peer's words (host memory, mapped)
  char* out_stage[LOAM_PEER_GENS][LOAM_PEER_MAX];  // a remote peer's staging, 2 * cap each way
  char* in_stage[LOAM_PEER_GENS][LOAM_PEER_MAX];
  unsigned long long* abort_word;              // host memory, mapped; the proxy raises it
  void* proxy;                                 // peer_proxy.cpp's, once started
};

__device__ __forceinline__ void st_release_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long ld_relaxed_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// thread 0 spins until *p >= want (acquire, system scope), then the block
// goes on; a remote flag (host memory, read over PCIe) with a nap between
// reads that doubles up to LOAM_PEER_NAP_MAX; past the timeout, or once the
// proxy raised the abort word, it names what it waited for and traps
__device__ void wait_at_least(const unsigned long long* p, unsigned long long want, const Job& job,
                              const char* what, int who, int chunk) {
  if (threadIdx.x == 0) {
    const bool remote = job.route[who].remote;
    const long long start = clock64();
    unsigned nap = 64, spins = 0;
    while (ld_acquire_sys(p) < want) {
      ++spins;
      if (remote) {
        __nanosleep(nap);
        nap = nap < LOAM_PEER_NAP_MAX ? 2 * nap : LOAM_PEER_NAP_MAX;
      }
      if (job.abort_word && !(spins & (remote ? 7u : 1023u)) && ld_relaxed_sys(job.abort_word)) {
        printf("peer collective: rank %d's proxy lost a socket while it waited for rank %d's %s (chunk %d) at "
               "epoch %llu\n", job.rank, who, what, chunk, want);
        __trap();
      }
      if (clock64() - start > job.timeout_cycles) {
        printf("peer collective: rank %d waited past its timeout for rank %d's %s (chunk %d) at epoch %llu\n",
               job.rank, who, what, chunk, want);
        __trap();
      }
    }
  }
  __syncthreads();
}

// ---- where a peer's chunks go and come from ----

__device__ __forceinline__ char* push_region(const Job& job, int t, unsigned long long e) {
  return job.route[t].push + (e & 1) * job.route[t].stride;
}

__device__ __forceinline__ const char* recv_region(const Job& job, int s, unsigned long long e) {
  return job.route[s].recv + (e & 1) * job.route[s].stride;
}

__device__ __forceinline__ const unsigned long long* recv_flag(const Job& job, int s, int k, unsigned long long e) {
  const Route& r = job.route[s];
  return r.recv_flags + (e & 1) * r.flag_stride + k;
}

__device__ __forceinline__ unsigned long long slice_bytes(const Job& job, int q) {
  const unsigned long long lo = q * job.slice;
  return lo >= job.total ? 0 : min(job.slice, job.total - lo);
}

// bytes of chunk k of slice q
__device__ __forceinline__ unsigned long long chunk_bytes(const Job& job, int q, int k) {
  const unsigned long long n = slice_bytes(job, q), lo = (unsigned long long)k * job.chunk;
  return lo >= n ? 0 : min(job.chunk, n - lo);
}

// where flag `slot`'s chunk for remote peer t lies in its region: {offset,
// bytes a piece, stride, (gen << 32) | pieces} (peer_link.h)
__device__ __forceinline__ void describe(const Job& job, int t, int slot, unsigned long long* d) {
  const unsigned long long gen = job.gen << 32;
  if (job.mode == kGather) {
    const unsigned long long lo = (unsigned long long)slot * job.chunk;
    d[0] = lo, d[1] = min(job.chunk, job.total - lo), d[2] = 0, d[3] = gen | 1;
  } else if (slot < LOAM_PEER_CHUNKS / 2) {  // a sum's first phase: the peer's slice of each block
    d[0] = (unsigned long long)slot * job.chunk, d[1] = chunk_bytes(job, t, slot), d[2] = job.slice, d[3] = gen | job.L;
  } else {  // its second: this rank's sums
    const int k = slot - LOAM_PEER_CHUNKS / 2;
    d[0] = job.L * job.slice + (unsigned long long)k * job.chunk, d[1] = chunk_bytes(job, job.rank, k), d[2] = 0,
    d[3] = gen | 1;
  }
}

// after the block's stores: flag `slot` of this rank raised to e at every
// peer (a remote peer's chunk description first, by the same thread)
__device__ __forceinline__ void raise_flags(const Job& job, int slot, unsigned long long e) {
  __syncthreads();  // the block's stores, then the flags
  const int t = threadIdx.x;
  if (t >= job.world || t == job.rank) return;
  const Route& r = job.route[t];
  if (r.remote) describe(job, t, slot, r.desc + ((e & 1) * LOAM_PEER_CHUNKS + slot) * 4);
  st_release_sys(r.push_flags + (e & 1) * r.flag_stride + slot, e);
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

// ---- gather ----

// chunk k of the packed payload, segment by segment, from the input (push:
// into this rank's region of every peer and the own output) or from sender
// `from`'s region here (receive: into `from`'s output)
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
        if (t != job.rank) dst[nd++] = push_region(job, t, e) + a;
      dst[nd++] = s.dst + job.rank * s.n + (a - s.off);
      copy(s.src + (a - s.off), dst, nd, b - a, false);
    } else {
      dst[nd++] = s.dst + from * s.n + (a - s.off);
      copy(recv_region(job, from, e) + a, dst, nd, b - a, true);
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

// phase one, push: chunk k of each peer's slice of the L blocks into this rank's region there
__device__ void sum_push(const Job& job, int k, unsigned long long e) {
  const unsigned long long lo = (unsigned long long)k * job.chunk;
  for (int t = 0; t < job.world; ++t) {
    const unsigned long long n = chunk_bytes(job, t, k);
    if (t == job.rank || n == 0) continue;
    char* base = push_region(job, t, e);
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
  return load(reinterpret_cast<const V*>(recv_region(job, q, e) + j * job.slice + lo) + at, true);
}

// phase one, receive, and phase two, push: chunk k of the own slice (n
// bytes at lo) added over every shard in global order, two units a thread
// at a time, into the output and this rank's region of every peer; V holds W
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
  uintptr_t a = reinterpret_cast<uintptr_t>(job.seg[0].src) | job.total;
  for (int d = 0; d < nd; ++d) a |= reinterpret_cast<uintptr_t>(dst[d]);
  if (!(a & 15)) sum_units<T, V, sizeof(V) / sizeof(T)>(job, e, lo, n, dst, nd);
  else sum_units<T, T, 1>(job, e, lo, n, dst, nd);
}

// phase one's receive and phase two's push of chunk k of the own slice
__device__ void sum_own(const Job& job, int k, unsigned long long e) {
  const int me = job.rank;
  const unsigned long long n = chunk_bytes(job, me, k), lo = (unsigned long long)k * job.chunk;
  for (int s = 0; s < job.world; ++s)
    if (s != me) wait_at_least(recv_flag(job, s, k, e), e, job, "slice chunk", s, k);
  if (n > 0) {
    char* dst[LOAM_PEER_MAX];
    int nd = 0;
    dst[nd++] = job.seg[0].dst + me * job.slice + lo;
    for (int t = 0; t < job.world; ++t)
      if (t != me) dst[nd++] = push_region(job, t, e) + job.L * job.slice + lo;
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
    wait_at_least(recv_flag(job, q, LOAM_PEER_CHUNKS / 2 + k, e), e, job, "sums chunk", q, k);
    const unsigned long long n = chunk_bytes(job, q, k);
    if (n == 0) continue;
    char* dst = job.seg[0].dst + q * job.slice + lo;
    copy(recv_region(job, q, e) + job.L * job.slice + lo, &dst, 1, n, true);
  }
}

__global__ void __launch_bounds__(LOAM_PEER_THREADS) peer_kernel(const __grid_constant__ Job job) {
  const int G = gridDim.x, me = job.rank, w = job.world;
  Control* ctl = job.ctl;
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
          if (t != me) wait_at_least(job.route[t].ack_from, e - 2, job, "acknowledgement", t, -1);
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
          wait_at_least(recv_flag(job, s, k1, e), e, job, "chunk", s, k1);
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
        if (t != me) st_release_sys(job.route[t].ack_to, e);
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

// pinned host memory the card reads and writes at the same address (UVA)
static cudaError_t host_alloc(void** p, size_t n) {
  cudaError_t err = cudaHostAlloc(p, n, cudaHostAllocMapped | cudaHostAllocPortable);
  void* d = nullptr;
  if (err == cudaSuccess) err = cudaHostGetDevicePointer(&d, *p, 0);
  if (err == cudaSuccess && d != *p) err = cudaErrorNotSupported;
  if (err != cudaSuccess && *p) {
    cudaFreeHost(*p);
    *p = nullptr;
  }
  return err;
}

// Who is on this rank's island: island[t] 1 for every rank t on it (this
// one too), 0 for a remote one; an island member's position orders its
// region in the mailboxes. Each remote peer gets its words (peer_link.h)
// and the rank an abort word, zeroed. Once, before the first mailbox.
extern "C" int loam_peer_routes(void* h, const int* island) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  if (s->gens || !island[s->rank]) return (int)cudaErrorInvalidValue;
  s->isl_n = 0;
  bool remote = false;
  for (int t = 0; t < s->world; ++t) {
    s->island[t] = island[t] != 0;
    if (s->island[t]) s->pos[t] = s->isl_n++;
    else remote = true;
  }
  if (!remote) return 0;
  cudaError_t err = host_alloc(reinterpret_cast<void**>(&s->abort_word), 64);
  if (err == cudaSuccess) memset(s->abort_word, 0, 64);
  for (int t = 0; t < s->world && err == cudaSuccess; ++t) {
    if (s->island[t]) continue;
    err = host_alloc(reinterpret_cast<void**>(&s->link[t]), sizeof(LoamLink));
    if (err == cudaSuccess) memset(s->link[t], 0, sizeof(LoamLink));
  }
  return (int)err;
}

// A new mailbox generation with regions of `cap` bytes (a multiple of 16),
// in use from now on: an own device mailbox of two slots of a region an
// island member (its IPC handle into `handle`; zeros where the island is
// this rank alone), and each remote peer's staging, two slots out and two
// in, registered with the proxy once it runs. The earlier ones stay.
extern "C" int loam_peer_mailbox(void* h, long long cap, void* handle) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  if (cap <= 0 || cap % 16 || s->gens == LOAM_PEER_GENS) return (int)cudaErrorInvalidValue;
  const int g = s->gens;
  char* box = nullptr;
  cudaError_t err = cudaSuccess;
  memset(handle, 0, sizeof(cudaIpcMemHandle_t));
  if (s->isl_n > 1) {
    err = cudaMalloc(&box, 2 * (size_t)s->isl_n * (size_t)cap);
    if (err == cudaSuccess) err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), box);
  }
  for (int t = 0; t < s->world && err == cudaSuccess; ++t) {
    if (s->island[t]) continue;
    err = host_alloc(reinterpret_cast<void**>(&s->out_stage[g][t]), 2 * (size_t)cap);
    if (err == cudaSuccess) err = host_alloc(reinterpret_cast<void**>(&s->in_stage[g][t]), 2 * (size_t)cap);
  }
  if (err != cudaSuccess) {
    cudaFree(box);
    for (int t = 0; t < s->world; ++t) {
      cudaFreeHost(s->out_stage[g][t]);
      cudaFreeHost(s->in_stage[g][t]);
      s->out_stage[g][t] = s->in_stage[g][t] = nullptr;
    }
    return (int)err;
  }
  s->own[g] = box;
  s->gens = g + 1;
  s->cap = (size_t)cap;
  s->mailbox[s->rank] = box;
  if (s->proxy) {
    for (int t = 0, i = 0; t < s->world; ++t)
      if (!s->island[t]) loam_proxy_stage(s->proxy, g, i++, s->out_stage[g][t], s->in_stage[g][t], cap);
  }
  return 0;
}

// After every rank made its new mailbox (the caller's exchange of handles
// orders that): open every island peer's, and its control words the first
// time. `handles`: a rank after another, the control words' handle then
// the mailbox's (2 x 64 bytes). *failed: the rank whose handle did not
// open, else -1.
extern "C" int loam_peer_open(void* h, const char* handles, int* failed) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  *failed = -1;
  const size_t hs = sizeof(cudaIpcMemHandle_t);
  for (int r = 0; r < s->world; ++r) {
    if (r == s->rank || !s->island[r]) continue;
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

// Start the rank's proxy (peer_proxy.cpp) over its remote peers: fds[t] a
// TCP socket connected to remote rank t's proxy (-1 elsewhere), owned by
// the proxy from now on. Every mailbox generation made so far is registered.
extern "C" int loam_peer_proxy(void* h, const int* fds) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  int socks[LOAM_PEER_MAX], n = 0;
  LoamLink* links[LOAM_PEER_MAX];
  for (int t = 0; t < s->world; ++t) {
    if (s->island[t]) continue;
    if (fds[t] < 0) return (int)cudaErrorInvalidValue;
    socks[n] = fds[t];
    links[n++] = s->link[t];
  }
  if (n == 0 || s->proxy) return (int)cudaErrorInvalidValue;
  s->proxy = loam_proxy_start(n, socks, links, s->abort_word);
  if (!s->proxy) return (int)cudaErrorInitializationError;
  for (int g = 0; g < s->gens; ++g)
    for (int t = 0, i = 0; t < s->world; ++t)
      if (!s->island[t]) loam_proxy_stage(s->proxy, g, i++, s->out_stage[g][t], s->in_stage[g][t], s->cap);
  return 0;
}

// Whether the proxy lost a link: 0 while every link is well (or there is no
// proxy); else the remote rank whose link failed plus one, and the reason
// into msg.
extern "C" int loam_peer_aborted(void* h, char* msg, int len) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  const int i = s->proxy ? loam_proxy_failed(s->proxy, msg, len) : 0;
  for (int t = 0, j = 1; i && t < s->world; ++t)
    if (!s->island[t] && j++ == i) return t + 1;
  return 0;
}

// The proxy's counters of the link to remote rank t (loam_proxy_counters):
// their number a direction, or -1 where t is not a remote peer or no proxy
// runs.
extern "C" int loam_peer_link_counters(void* h, int t, unsigned long long* out) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  if (!s->proxy || t < 0 || t >= s->world || s->island[t]) return -1;
  int i = 0;
  for (int r = 0; r < t; ++r) i += !s->island[r];
  return loam_proxy_counters(s->proxy, i, out);
}

// Close every island peer's mapping here (first step of a release: the
// caller then waits for every rank to have closed its own before
// loam_peer_free).
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

// Stop the proxy (after every rank's last collective: the caller's exchange
// orders that), free the own buffers, the staging and the state.
extern "C" int loam_peer_free(void* h) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  loam_proxy_stop(s->proxy);
  cudaError_t first = cudaSuccess;
  const auto keep = [&first](cudaError_t err) {
    if (first == cudaSuccess) first = err;
  };
  for (int g = 0; g < s->gens; ++g) {
    if (s->own[g]) keep(cudaFree(s->own[g]));
    for (int t = 0; t < s->world; ++t) {
      if (s->out_stage[g][t]) keep(cudaFreeHost(s->out_stage[g][t]));
      if (s->in_stage[g][t]) keep(cudaFreeHost(s->in_stage[g][t]));
    }
  }
  for (int t = 0; t < s->world; ++t)
    if (s->link[t]) keep(cudaFreeHost(s->link[t]));
  if (s->abort_word) keep(cudaFreeHost(s->abort_word));
  if (s->ctl) keep(cudaFree(s->ctl));
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
  if (s->world > 1 && (payload > s->cap || s->gens == 0)) return (int)cudaErrorInvalidValue;
  Job job;
  memset(&job, 0, sizeof(Job));
  const int gen = s->gens - 1;
  const unsigned long long cap = s->cap;
  for (int t = 0; t < s->world; ++t) {
    if (t == s->rank) continue;
    Route& r = job.route[t];
    if (s->island[t]) {
      r.push = s->mailbox[t] + s->pos[s->rank] * cap;
      r.recv = s->mailbox[s->rank] + s->pos[t] * cap;
      r.stride = (unsigned long long)s->isl_n * cap;
      r.push_flags = s->ctls[t]->flags[s->rank];
      r.recv_flags = s->ctl->flags[t];
      r.ack_to = &s->ctls[t]->acks[s->rank];
      r.ack_from = &s->ctl->acks[t];
    } else {
      LoamLink* w = s->link[t];
      r.push = s->out_stage[gen][t];
      r.recv = s->in_stage[gen][t];
      r.stride = cap;
      r.push_flags = &w->out_flags[0][0];
      r.recv_flags = &w->in_flags[0][0];
      r.desc = &w->out_desc[0][0][0];
      r.ack_to = &w->ack_out;
      r.ack_from = &w->ack_in;
      r.flag_stride = LOAM_PEER_CHUNKS;
      r.remote = 1;
      job.abort_word = s->abort_word;
    }
  }
  job.ctl = s->ctl;
  job.gen = gen < 0 ? 0 : (unsigned long long)gen;
  job.world = s->world;
  job.rank = s->rank;
  job.mode = mode;
  job.dtype = dtype;
  job.nseg = nseg;
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
