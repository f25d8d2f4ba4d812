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
// (peer_link.h, peer_proxy.cpp), at any world size.
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
// each other's memory, a card itself included: ranks that share a card are
// an island too) or remote (every other rank: another host, or a card this
// one cannot reach). Each collective reaches every peer through a Route:
// where this rank pushes its region for the peer and raises the peer's
// flags and acknowledgement, where the peer's region for this rank lands
// and its flags and acknowledgement arrive. The routes of a mailbox
// generation are a table in device memory, one entry a rank, written when
// the generation is set up (never inside a capture: a graph keeps the
// table's address), so the kernel's arguments do not grow with the world.
// The kernel's pushes, waits and copies are the same for both kinds; only
// the memory and where a chunk lies in it differ.
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
//            for each remote peer two slots of `window` bytes out and two in,
//            made once with the mesh: what a remote peer is sent in one
//            epoch never outgrows a slot, since a collective whose payload
//            a remote peer would outgrow it runs in pieces (below). The
//            words of peer_link.h (flags and chunk descriptions a slot,
//            acknowledgements) beside it. The kernel stores a chunk into the
//            out staging over PCIe, writes where it lies and raises its flag
//            (release, system scope); the rank's proxy (peer_proxy.cpp)
//            sends it over TCP to the peer's proxy, each run of consecutive
//            raised chunks one message, which lands it in that rank's in
//            staging and raises the flags there; the peer's kernel waits on
//            it (acquire, system scope, with a growing __nanosleep between
//            reads, so the spin does not flood PCIe) and copies the chunk in
//            (L2-only loads, never L1). Acknowledgements cross the same
//            way. A rank pins 4 x window bytes a remote peer, whatever the
//            payloads;
//   control  (device) the epoch (collectives' pieces done), a ticket, the
//            longest wait; then acks[i]: the last epoch island member i
//            finished reading its mailbox; flags[i][k]: the last epoch
//            island member i pushed chunk k here. Sized by the island.
// Every rank issues the same collectives in the same order (the mesh's
// replicated control flow), so the epochs stay in step.
//
// One collective, one kernel on the caller's stream. Its payload (the
// segments packed at 16-byte offsets; in a sum the range of a block) is cut
// into chunks, a block a chunk up to what the card holds at once. On a mesh
// with remote peers the chunks go in pieces of at most what fills a staging
// slot (a gather: `window` / chunk chunks; a sum: `window` / ((L + 1)
// chunk)), each piece one epoch of its own, e, e + 1, ...: a piece is a
// collective of the protocol below over its chunks, its remote chunks at
// their offsets within the piece, and every block ends a piece before any
// starts the next (the grid barrier is the piece's last block storing its
// epoch, which the others wait for). Without a remote peer a collective is
// one piece. Block b takes the piece's chunks k = k0 + b, k0 + b + G, ...
// and, for each, pushes it and then receives the one before (which the
// peers' blocks b pushed a step earlier, so the wait overlaps this block's
// push):
//   push     once a piece, wait until every peer t acknowledged epoch e - 2
//            (the credit to rewrite slot e % 2; in steady state it is there);
//            then copy chunk k from the source into this rank's region of
//            every peer's slot e % 2 (an island peer's mailbox over NVLink,
//            a remote peer's out staging over PCIe; stores, 16 bytes a
//            thread and four in flight), and in a gather into the rank's
//            own output; then a barrier, and the block's threads raise each
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
// writes a region a peer still reads (a rank runs two epochs ahead of a
// peer only past one that moves nothing, which waits for no one; the
// protocol is modelled in tests/test_torch_peer_gather.py, pieces too);
// flags only grow, and a flag >= e means chunk k of epoch e is in place (a
// later epoch's flag follows the whole earlier piece). The grid never
// exceeds what the card holds at once, so every block of a rank runs while
// it waits.
//
// At one rank no mailbox, no flag: a gather is one copy kernel, a sum reads
// the L blocks and writes one. A spin is bounded: past `timeout_cycles` of
// clock64 it prints what it waited for and traps, so a rank that never
// arrives makes the call raise (a sticky launch failure) instead of
// hanging; where a proxy lost its socket it raised the abort word, which
// every spin of a rank with remote peers reads, and the kernel traps at
// once. Each spin that waited stores its cycles into the control words'
// longest wait (atomicMax), which the host reads after a run
// (loam_peer_max_wait) against the timeout.
//
// Nothing here is sized by the world: the routes are a table, the control
// words are sized by the island, a block's per-peer pointers are in
// dynamic shared memory (3 words a rank), and a push loops over its peers
// one destination at a time with its loads in registers. What limits the
// world is memory: the mailbox (2 x island x cap device bytes), the staging
// (4 x window pinned bytes a remote peer), and the shared memory a block
// (24 bytes a rank, within the 48 KB a launch takes without opting in).
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

#include <vector>

#include "peer_link.h"

#define LOAM_PEER_THREADS 512
#define LOAM_PEER_SEGS 64        // segments (leaves) of one gather
#define LOAM_PEER_CHUNK_MIN (4 << 10)   // a chunk's bytes: at least this,
#define LOAM_PEER_CHUNK_MAX (64 << 10)  // and at most this unless the flags run out
#define LOAM_PEER_UNROLL 8       // 16-byte loads in flight a thread (a copy to one place)
#define LOAM_PEER_NAP_MAX 4096   // ns: the longest nap between two reads of a remote flag
#define LOAM_PEER_SMEM_MAX (48 << 10)   // a block's dynamic shared memory without the opt-in
#define LOAM_PEER_SMEM_RANK 24   // its bytes a rank: a destination, a source base and its stride

enum { kGather = 0, kSum = 1 };
enum { kF32 = 0, kF64 = 1, kI32 = 2, kI64 = 3 };

// the control words' head; acks[island] and flags[island][LOAM_PEER_CHUNKS] follow
struct Control {
  unsigned long long epoch;
  unsigned int ticket, pad;
  unsigned long long max_wait;  // cycles
  unsigned long long pad2;
};
static_assert(sizeof(Control) % 16 == 0, "the acks and flags follow 16-byte aligned");

__host__ __device__ inline unsigned long long* ctl_acks(Control* c) { return reinterpret_cast<unsigned long long*>(c + 1); }
__host__ __device__ inline unsigned long long* ctl_flags(Control* c, int isl_n, int i) {
  return ctl_acks(c) + isl_n + (size_t)i * LOAM_PEER_CHUNKS;
}
static size_t control_bytes(int isl_n) {
  return sizeof(Control) + (size_t)isl_n * (1 + LOAM_PEER_CHUNKS) * sizeof(unsigned long long);
}

struct Segment {
  const char* src;
  char* dst;
  unsigned long long off;  // in the packed payload, a multiple of 16
  unsigned long long n;    // bytes a rank
};

// how this rank reaches one peer (module comment); a generation's table
// holds one a rank (this rank's own unused)
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
  int remote;                           // 1: chunks at their offsets within the piece, flags counted from it
};

struct Job {
  const Route* route;             // the generation's table, one a rank
  Control* ctl;                   // this rank's: the epoch and the ticket
  const unsigned long long* abort_word;  // raised by the proxy; null without a remote peer
  int world, rank, mode, dtype, nseg, chunks;
  int pieces, piece_chunks;       // the collective's pieces (an epoch each) and chunks a piece
  unsigned long long total;       // gather: packed bytes a rank; sum: bytes a block
  unsigned long long slice;       // sum: bytes of a block a rank adds up (a multiple of 16)
  unsigned long long chunk;       // bytes a chunk (of the payload; of a slice)
  unsigned long long L;           // sum: blocks a rank
  long long timeout_cycles;
  Segment seg[LOAM_PEER_SEGS];    // sum: seg[0] is the input (L blocks) and the output
};
static_assert(sizeof(Job) <= 4096, "a kernel's arguments fit in 4 KB");

struct LoamPeer {
  int world = 0, rank = 0, grid_max = 0, isl_n = 0;
  long long timeout_cycles = 0;
  unsigned long long window = 0;              // bytes of a remote peer's staging slot
  size_t smem = 0;                            // dynamic shared memory a block
  size_t cap = 0;                             // bytes a region of the mailbox in use
  std::vector<int> island, pos;               // island[t] 1 on this rank's island (itself too); a member's region
  std::vector<char*> own;                     // a generation's own mailbox, 2 * isl_n * its cap (none alone)
  std::vector<size_t> caps;                   // a generation's cap
  std::vector<std::vector<char*>> mapped;     // a generation's island peers' mailboxes opened here
  std::vector<Route*> routes;                 // a generation's table (device memory)
  Control* ctl = nullptr;                     // own
  std::vector<char*> mailbox;                 // the island's mailboxes in use
  std::vector<Control*> ctls;                 // the island's control words
  std::vector<LoamLink*> link;                // a remote peer's words (host memory, mapped)
  std::vector<char*> out_stage, in_stage;     // a remote peer's staging, 2 * window each way
  unsigned long long* abort_word = nullptr;   // host memory, mapped; the proxy raises it
  void* proxy = nullptr;                      // peer_proxy.cpp's, once started
  bool remote = false;                        // any remote peer
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
// proxy raised the abort word, it names what it waited for and traps; a
// wait that spun stores its cycles into the longest wait
__device__ void wait_at_least(const unsigned long long* p, unsigned long long want, const Job& job,
                              const char* what, int who, int chunk) {
  if (threadIdx.x == 0) {
    const bool remote = who != job.rank && job.route[who].remote;
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
    if (spins) atomicMax(&job.ctl->max_wait, (unsigned long long)(clock64() - start));
  }
  __syncthreads();
}

// ---- where a peer's chunks go and come from ----

__device__ __forceinline__ char* push_region(const Route& r, unsigned long long e) {
  return r.push + (e & 1) * r.stride;
}

__device__ __forceinline__ const char* recv_region(const Route& r, unsigned long long e) {
  return r.recv + (e & 1) * r.stride;
}

// chunk k's place in a peer's region (of a slice's part, in a sum): an
// island peer's mailbox holds the whole payload, a remote peer's staging
// the piece from chunk k0 on
__device__ __forceinline__ unsigned long long chunk_off(const Job& job, const Route& r, int k, int k0) {
  return (unsigned long long)(r.remote ? k - k0 : k) * job.chunk;
}

// bytes from one of a sum's parts (a block's slice) to the next in a region
__device__ __forceinline__ unsigned long long part_stride(const Job& job, const Route& r) {
  return r.remote ? (unsigned long long)job.piece_chunks * job.chunk : job.slice;
}

// flag `phase` (0: a gather's or a sum's first phase; 1: its second) of chunk k
__device__ __forceinline__ int flag_index(const Route& r, int k, int k0, int phase) {
  return phase * (LOAM_PEER_CHUNKS / 2) + (r.remote ? k - k0 : k);
}

__device__ __forceinline__ const unsigned long long* recv_flag(const Job& job, int s, int k, int k0, int phase,
                                                               unsigned long long e) {
  const Route& r = job.route[s];
  return r.recv_flags + (e & 1) * r.flag_stride + flag_index(r, k, k0, phase);
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

// where remote peer t's chunk k (piece from k0, phase `phase`) lies in its
// staging slot: {offset, bytes a piece, stride, pieces} (peer_link.h)
__device__ __forceinline__ void describe(const Job& job, int t, int k, int k0, int phase, unsigned long long* d) {
  const Route& r = job.route[t];
  const unsigned long long at = chunk_off(job, r, k, k0);
  if (job.mode == kGather) {
    const unsigned long long lo = (unsigned long long)k * job.chunk;
    d[0] = at, d[1] = min(job.chunk, job.total - lo), d[2] = 0, d[3] = 1;
  } else if (phase == 0) {  // a sum's first phase: the peer's slice of each block
    d[0] = at, d[1] = chunk_bytes(job, t, k), d[2] = part_stride(job, r), d[3] = job.L;
  } else {  // its second: this rank's sums
    d[0] = job.L * part_stride(job, r) + at, d[1] = chunk_bytes(job, job.rank, k), d[2] = 0, d[3] = 1;
  }
}

// after the block's stores: flag `phase` of chunk k raised to e at every
// peer (a remote peer's chunk description first, by the same thread)
__device__ void raise_flags(const Job& job, int k, int k0, int phase, unsigned long long e) {
  __syncthreads();  // the block's stores, then the flags
  for (int t = threadIdx.x; t < job.world; t += blockDim.x) {
    if (t == job.rank) continue;
    const Route& r = job.route[t];
    const int f = flag_index(r, k, k0, phase);
    if (r.remote) describe(job, t, k, k0, phase, r.desc + ((e & 1) * LOAM_PEER_CHUNKS + f) * 4);
    st_release_sys(r.push_flags + (e & 1) * r.flag_stride + f, e);
  }
}

template <typename V>
__device__ __forceinline__ V load(const V* p, bool l2) {
  return l2 ? __ldcg(p) : *p;
}

// n bytes from src to each of dst[0..nd) (a block's destinations, in
// shared memory): V-wide units (every address V-aligned), U loads in flight
// a thread, stored to one destination after another, then the tail a byte
// a thread
template <typename V, int U>
__device__ void copy_units(const char* src, char* const* dst, int nd, size_t n, bool l2) {
  const size_t units = n / sizeof(V), lanes = blockDim.x;
  const V* s = reinterpret_cast<const V*>(src);
  size_t i = threadIdx.x;
  for (; i + (U - 1) * lanes < units; i += U * lanes) {
    V v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = load(s + i + u * lanes, l2);
    for (int d = 0; d < nd; ++d) {
      V* o = reinterpret_cast<V*>(dst[d]);
#pragma unroll
      for (int u = 0; u < U; ++u) o[i + u * lanes] = v[u];
    }
  }
  for (; i < units; i += lanes) {
    const V v = load(s + i, l2);
    for (int d = 0; d < nd; ++d) reinterpret_cast<V*>(dst[d])[i] = v;
  }
  for (size_t t = units * sizeof(V) + threadIdx.x; t < n; t += lanes) {
    const char c = load(reinterpret_cast<const unsigned char*>(src) + t, l2);
    for (int d = 0; d < nd; ++d) dst[d][t] = c;
  }
}

template <typename V>
__device__ void copy_to(const char* src, char* const* dst, int nd, size_t n, bool l2) {
  // one destination (a copy out of the mailbox, a rank's own block) keeps
  // LOAM_PEER_UNROLL loads in flight; several (the pushes) half as many
  if (nd == 1) copy_units<V, LOAM_PEER_UNROLL>(src, dst, 1, n, l2);
  else copy_units<V, LOAM_PEER_UNROLL / 2>(src, dst, nd, n, l2);
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

// a block's per-rank pointers (dynamic shared memory, LOAM_PEER_SMEM_RANK
// bytes a rank): destinations of a push, and a sum's shard bases and strides
extern __shared__ unsigned long long smem[];

__device__ __forceinline__ char** dsts(const Job&) { return reinterpret_cast<char**>(smem); }
__device__ __forceinline__ const char** bases(const Job& job) {
  return reinterpret_cast<const char**>(smem + job.world);
}
__device__ __forceinline__ unsigned long long* strides(const Job& job) { return smem + 2 * job.world; }

// ---- gather ----

// chunk k (of the piece from k0) of the packed payload, segment by
// segment, from the input (push: into this rank's region of every peer and
// the own output) or from sender `from`'s region here (receive: into
// `from`'s output)
__device__ void gather_chunk(const Job& job, int k, int k0, unsigned long long e, int from) {
  const unsigned long long lo = (unsigned long long)k * job.chunk;
  const unsigned long long hi = min(lo + job.chunk, job.total);
  char** dst = dsts(job);
  for (int i = 0; i < job.nseg; ++i) {
    const Segment& s = job.seg[i];
    const unsigned long long a = max(lo, s.off), b = min(hi, s.off + s.n);
    if (a >= b) continue;
    if (from < 0) {
      // the peers' regions then the own output, one a thread
      for (int t = threadIdx.x; t < job.world; t += blockDim.x) {
        if (t == job.rank) {
          dst[job.world - 1] = s.dst + job.rank * s.n + (a - s.off);
        } else {
          const Route& r = job.route[t];
          dst[t - (t > job.rank)] = push_region(r, e) + chunk_off(job, r, k, k0) + (a - lo);
        }
      }
      __syncthreads();
      copy(s.src + (a - s.off), dst, job.world, b - a, false);
      __syncthreads();  // before the next segment's destinations
    } else {
      const Route& r = job.route[from];
      char* out = s.dst + from * s.n + (a - s.off);
      copy(recv_region(r, e) + chunk_off(job, r, k, k0) + (a - lo), &out, 1, b - a, true);
    }
  }
}

// ---- sum: a reduce-scatter and an all-gather in one kernel ----
// Rank q adds up slice q of the block (bytes [q S, (q + 1) S), cut at the
// block's end) over every shard in global order and sends the sums to every
// peer. A sender's region holds the slices it sends: its L blocks' slice of
// the owner (L parts), then its own slice's sums (one part); an island
// peer's part is the whole slice, a remote peer's the piece's chunks. Flag
// k says phase one's chunk k is in place, flag LOAM_PEER_CHUNKS / 2 + k
// phase two's (a remote peer's counted from the piece's first chunk).

// phase one, push: chunk k of each peer's slice of the L blocks into this rank's region there
__device__ void sum_push(const Job& job, int k, int k0, unsigned long long e) {
  const unsigned long long lo = (unsigned long long)k * job.chunk;
  for (int t = 0; t < job.world; ++t) {
    const unsigned long long n = chunk_bytes(job, t, k);
    if (t == job.rank || n == 0) continue;
    const Route& r = job.route[t];
    char* base = push_region(r, e) + chunk_off(job, r, k, k0);
    const unsigned long long stride = part_stride(job, r);
    for (unsigned long long j = 0; j < job.L; ++j) {
      char* dst = base + j * stride;
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

// the V-th unit `at` of the chunk in global shard g's block: rank g / L's
// base (its part of block 0, set up by sum_own) plus the block's stride
template <typename V>
__device__ __forceinline__ V shard_unit(const Job& job, unsigned long long g, unsigned long long at) {
  const int q = (int)(g / job.L);
  const unsigned long long j = g % job.L;
  const V* p = reinterpret_cast<const V*>(bases(job)[q] + j * strides(job)[q]) + at;
  return load(p, q != job.rank);
}

// phase one, receive, and phase two, push: the chunk of the own slice (n
// bytes) added over every shard in global order, two units a thread at a
// time, into each of dst[0..nd) (the output and this rank's region of
// every peer); V holds W elements of T
template <typename T, typename V, int W>
__device__ void sum_units(const Job& job, unsigned long long n, char* const* dst, int nd) {
  const unsigned long long shards = job.world * job.L, units = n / sizeof(V), lanes = blockDim.x;
  for (unsigned long long i = threadIdx.x; i < units; i += 2 * lanes) {
    const bool two = i + lanes < units;
    V acc[2];
    acc[0] = shard_unit<V>(job, 0, i);
    if (two) acc[1] = shard_unit<V>(job, 0, i + lanes);
    for (unsigned long long g = 1; g < shards; ++g) {
      V v[2];
      v[0] = shard_unit<V>(job, g, i);
      if (two) v[1] = shard_unit<V>(job, g, i + lanes);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        T* a = reinterpret_cast<T*>(&acc[u]);
        const T* b = reinterpret_cast<const T*>(&v[u]);
#pragma unroll
        for (int w = 0; w < W; ++w) a[w] = add(a[w], b[w]);
      }
    }
    for (int d = 0; d < nd; ++d) {
      reinterpret_cast<V*>(dst[d])[i] = acc[0];
      if (two) reinterpret_cast<V*>(dst[d])[i + lanes] = acc[1];
    }
  }
}

template <typename T, typename V>
__device__ void sum_typed(const Job& job, unsigned long long n, char* const* dst, int nd) {
  uintptr_t a = reinterpret_cast<uintptr_t>(job.seg[0].src) | job.total;
  for (int q = 0; q < job.world; ++q) a |= reinterpret_cast<uintptr_t>(bases(job)[q]) | strides(job)[q];
  for (int d = 0; d < nd; ++d) a |= reinterpret_cast<uintptr_t>(dst[d]);
  if (!(a & 15)) sum_units<T, V, sizeof(V) / sizeof(T)>(job, n, dst, nd);
  else sum_units<T, T, 1>(job, n, dst, nd);
}

// phase one's receive and phase two's push of chunk k of the own slice
__device__ void sum_own(const Job& job, int k, int k0, unsigned long long e) {
  const int me = job.rank;
  const unsigned long long n = chunk_bytes(job, me, k), lo = (unsigned long long)k * job.chunk;
  for (int s = 0; s < job.world; ++s)
    if (s != me) wait_at_least(recv_flag(job, s, k, k0, 0, e), e, job, "slice chunk", s, k);
  if (n > 0) {
    // every rank's part of block 0 and its stride (the own from the input),
    // then the destinations: the output and each peer's region
    char** dst = dsts(job);
    for (int q = threadIdx.x; q < job.world; q += blockDim.x) {
      if (q == me) {
        bases(job)[q] = job.seg[0].src + me * job.slice + lo;
        strides(job)[q] = job.total;
        dst[0] = job.seg[0].dst + me * job.slice + lo;
      } else {
        const Route& r = job.route[q];
        const unsigned long long part = part_stride(job, r), at = chunk_off(job, r, k, k0);
        bases(job)[q] = recv_region(r, e) + at;
        strides(job)[q] = part;
        dst[q + (q < me)] = push_region(r, e) + job.L * part + at;
      }
    }
    __syncthreads();
    switch (job.dtype) {
      case kF32: sum_typed<float, float4>(job, n, dst, job.world); break;
      case kF64: sum_typed<double, double2>(job, n, dst, job.world); break;
      case kI32: sum_typed<int, int4>(job, n, dst, job.world); break;
      default: sum_typed<long long, longlong2>(job, n, dst, job.world); break;
    }
  }
  if (job.world > 1) raise_flags(job, k, k0, 1, e);
  __syncthreads();  // the block's pointers, before the next chunk rewrites them
}

// phase two, receive: chunk k of every peer's slice of sums into the output
__device__ void sum_collect(const Job& job, int k, int k0, unsigned long long e) {
  const unsigned long long lo = (unsigned long long)k * job.chunk;
  for (int q = 0; q < job.world; ++q) {
    if (q == job.rank) continue;
    wait_at_least(recv_flag(job, q, k, k0, 1, e), e, job, "sums chunk", q, k);
    const unsigned long long n = chunk_bytes(job, q, k);
    if (n == 0) continue;
    const Route& r = job.route[q];
    char* dst = job.seg[0].dst + q * job.slice + lo;
    copy(recv_region(r, e) + job.L * part_stride(job, r) + chunk_off(job, r, k, k0), &dst, 1, n, true);
  }
}

// one rank: the gather a copy, the sum the L blocks added in order
__device__ void one_rank(const Job& job) {
  for (int k = blockIdx.x; k < job.chunks; k += gridDim.x) {
    if (job.mode == kGather) {
      gather_chunk(job, k, 0, 0, -1);
    } else {
      sum_own(job, k, 0, 0);
    }
  }
}

// the piece's chunks k0 .. k1 - 1, epoch e, as a pipeline: step i pushes
// chunk k_i = k0 + b + i G, and receives what the peers' blocks b pushed a
// step earlier (a gather's k_(i-1); a sum's phase one of k_(i-1), whose
// sums it pushes, and phase two of k_(i-2))
__device__ void piece(const Job& job, int k0, int k1, unsigned long long e) {
  const int G = gridDim.x, me = job.rank, w = job.world;
  const int lag = job.mode == kSum ? 2 : 1;
  for (int i = 0;; ++i) {
    const int k = k0 + blockIdx.x + i * G;
    if (k >= k1 + lag * G) break;
    if (k < k1) {
      if (i == 0 && e > 2) {
        for (int t = 0; t < w; ++t)
          if (t != me) wait_at_least(job.route[t].ack_from, e - 2, job, "acknowledgement", t, -1);
      }
      if (job.mode == kGather) gather_chunk(job, k, k0, e, -1);
      else sum_push(job, k, k0, e);
      raise_flags(job, k, k0, 0, e);
    }
    const int ka = k - G, kb = k - 2 * G;
    if (job.mode == kGather) {
      if (ka >= k0 && ka < k1)
        for (int s = 0; s < w; ++s) {
          if (s == me) continue;
          wait_at_least(recv_flag(job, s, ka, k0, 0, e), e, job, "chunk", s, ka);
          gather_chunk(job, ka, k0, e, s);
        }
    } else {
      if (ka >= k0 && ka < k1) sum_own(job, ka, k0, e);
      if (kb >= k0 && kb < k1) sum_collect(job, kb, k0, e);
    }
  }
}

__global__ void __launch_bounds__(LOAM_PEER_THREADS) peer_kernel(const __grid_constant__ Job job) {
  if (job.world == 1) {
    one_rank(job);
    return;
  }
  Control* ctl = job.ctl;
  const unsigned long long e0 = *reinterpret_cast<volatile unsigned long long*>(&ctl->epoch) + 1;
  __shared__ int last;
  for (int p = 0; p < job.pieces; ++p) {
    const unsigned long long e = e0 + p;
    const int k0 = p * job.piece_chunks, k1 = min(job.chunks, k0 + job.piece_chunks);
    piece(job, k0, k1, e);
    // the last block out: the epoch, and the acknowledgement to every
    // peer; before the next piece every block waits for that epoch
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      last = atomicAdd(&ctl->ticket, 1u) == gridDim.x - 1;
      if (last) {
        atomicExch(&ctl->ticket, 0u);
        __threadfence();
        st_release_sys(&ctl->epoch, e);
        for (int t = 0; t < job.world; ++t)
          if (t != job.rank) st_release_sys(job.route[t].ack_to, e);
      }
    }
    __syncthreads();
    if (!last && p + 1 < job.pieces) wait_at_least(&ctl->epoch, e, job, "the piece's last block", job.rank, -1);
  }
}

extern "C" int loam_peer_max_segments() { return LOAM_PEER_SEGS; }

// The state of a mesh's rank `rank` of `world` on the current device, with
// remote staging slots of `window` bytes: no island, no mailbox yet. Its
// handle into *out. A world whose per-rank pointers outgrow a block's
// shared memory: cudaErrorInvalidValue (loam_peer_world_max names it).
extern "C" int loam_peer_world_max() { return LOAM_PEER_SMEM_MAX / LOAM_PEER_SMEM_RANK; }

extern "C" int loam_peer_create(int world, int rank, double timeout_s, long long window, void** out) {
  if (world < 1 || world > loam_peer_world_max() || rank < 0 || rank >= world || window < 16 || window % 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)world * LOAM_PEER_SMEM_RANK;
  int dev, khz, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, peer_kernel, LOAM_PEER_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (sms * per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  LoamPeer* s = new LoamPeer;
  s->world = world;
  s->rank = rank;
  s->timeout_cycles = (long long)(timeout_s * khz * 1e3);
  s->window = (unsigned long long)window;
  s->smem = smem;
  // every block of a grid resident at once: a block that waits never keeps
  // another, whose chunks a peer waits for, off the card
  s->grid_max = sms * per_sm;
  s->island.assign(world, 0);
  s->pos.assign(world, 0);
  s->island[rank] = 1;
  s->isl_n = 1;
  s->mailbox.assign(world, nullptr);
  s->ctls.assign(world, nullptr);
  s->link.assign(world, nullptr);
  s->out_stage.assign(world, nullptr);
  s->in_stage.assign(world, nullptr);
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
// ways (*ok 1; a card with itself: 1, so ranks that share a card are one
// island over IPC). *ok is -1 where this process does not see one of them:
// cudaIpcOpenMemHandle decides then.
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
// region in the mailboxes and its flags in the control words, which are
// made here, zeroed. Each remote peer gets its words (peer_link.h) and its
// staging, two slots of the window each way, and the rank an abort word,
// zeroed. Once, before the first mailbox.
extern "C" int loam_peer_routes(void* h, const int* island) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  if (s->ctl || !island[s->rank]) return (int)cudaErrorInvalidValue;
  s->isl_n = 0;
  for (int t = 0; t < s->world; ++t) {
    s->island[t] = island[t] != 0;
    if (s->island[t]) s->pos[t] = s->isl_n++;
    else s->remote = true;
  }
  const size_t ctl = control_bytes(s->isl_n);
  cudaError_t err = cudaMalloc(&s->ctl, ctl);
  if (err == cudaSuccess) err = cudaMemset(s->ctl, 0, ctl);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return (int)err;
  s->ctls[s->rank] = s->ctl;
  if (!s->remote) return 0;
  err = host_alloc(reinterpret_cast<void**>(&s->abort_word), 64);
  if (err == cudaSuccess) memset(s->abort_word, 0, 64);
  for (int t = 0; t < s->world && err == cudaSuccess; ++t) {
    if (s->island[t]) continue;
    err = host_alloc(reinterpret_cast<void**>(&s->link[t]), sizeof(LoamLink));
    if (err == cudaSuccess) memset(s->link[t], 0, sizeof(LoamLink));
    if (err == cudaSuccess) err = host_alloc(reinterpret_cast<void**>(&s->out_stage[t]), 2 * s->window);
    if (err == cudaSuccess) err = host_alloc(reinterpret_cast<void**>(&s->in_stage[t]), 2 * s->window);
  }
  return (int)err;
}

// A new mailbox generation with regions of `cap` bytes (a multiple of 16),
// in use from now on: an own device mailbox of two slots of a region an
// island member (its IPC handle into `handle`; zeros where the island is
// this rank alone). The earlier ones stay.
extern "C" int loam_peer_mailbox(void* h, long long cap, void* handle) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  if (cap <= 0 || cap % 16 || !s->ctl) return (int)cudaErrorInvalidValue;
  char* box = nullptr;
  memset(handle, 0, sizeof(cudaIpcMemHandle_t));
  if (s->isl_n > 1) {
    cudaError_t err = cudaMalloc(&box, 2 * (size_t)s->isl_n * (size_t)cap);
    if (err == cudaSuccess) err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), box);
    if (err != cudaSuccess) {
      cudaFree(box);
      return (int)err;
    }
  }
  s->own.push_back(box);
  s->caps.push_back((size_t)cap);
  s->mapped.emplace_back(s->world, nullptr);
  s->routes.push_back(nullptr);
  s->cap = (size_t)cap;
  s->mailbox[s->rank] = box;
  return 0;
}

// the route table of the generation in use, from the mappings (host side)
static void fill_routes(const LoamPeer* s, std::vector<Route>& out) {
  out.assign(s->world, Route{});
  const size_t cap = s->cap;
  for (int t = 0; t < s->world; ++t) {
    if (t == s->rank) continue;
    Route& r = out[t];
    if (s->island[t]) {
      r.push = s->mailbox[t] + s->pos[s->rank] * cap;
      r.recv = s->mailbox[s->rank] + s->pos[t] * cap;
      r.stride = (unsigned long long)s->isl_n * cap;
      r.push_flags = ctl_flags(s->ctls[t], s->isl_n, s->pos[s->rank]);
      r.recv_flags = ctl_flags(s->ctl, s->isl_n, s->pos[t]);
      r.ack_to = ctl_acks(s->ctls[t]) + s->pos[s->rank];
      r.ack_from = ctl_acks(s->ctl) + s->pos[t];
    } else {
      LoamLink* w = s->link[t];
      r.push = s->out_stage[t];
      r.recv = s->in_stage[t];
      r.stride = s->window;
      r.push_flags = &w->out_flags[0][0];
      r.recv_flags = &w->in_flags[0][0];
      r.desc = &w->out_desc[0][0][0];
      r.ack_to = &w->ack_out;
      r.ack_from = &w->ack_in;
      r.flag_stride = LOAM_PEER_CHUNKS;
      r.remote = 1;
    }
  }
}

// After every rank made its new mailbox (the caller's exchange of handles
// orders that): open every island peer's, and its control words the first
// time; then write the generation's route table (device memory; never
// inside a capture). The copy is waited for: a copy from pageable memory
// returns before its bytes land, and the kernel may run on a stream that
// does not wait for the legacy one (a program's warm-up runs on a side
// stream), where it would read a table not yet written. `handles`: a rank
// after another, the control words' handle then the mailbox's (2 x 64
// bytes). *failed: the rank whose handle did not open, else -1.
extern "C" int loam_peer_open(void* h, const char* handles, int* failed) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  *failed = -1;
  if (s->own.empty()) return (int)cudaErrorInvalidValue;
  const size_t hs = sizeof(cudaIpcMemHandle_t);
  const size_t g = s->own.size() - 1;
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
      s->mapped[g][r] = s->mailbox[r] = static_cast<char*>(p);
    }
    if (err != cudaSuccess) {
      *failed = r;
      return (int)err;
    }
  }
  std::vector<Route> table;
  fill_routes(s, table);
  const size_t n = table.size() * sizeof(Route);
  cudaError_t err = cudaMalloc(&s->routes[g], n);
  if (err == cudaSuccess) err = cudaMemcpyAsync(s->routes[g], table.data(), n, cudaMemcpyHostToDevice, 0);
  if (err == cudaSuccess) err = cudaStreamSynchronize(0);
  return (int)err;
}

// Start the rank's proxy (peer_proxy.cpp) over its remote peers: fds[t] a
// TCP socket connected to remote rank t's proxy (-1 elsewhere), owned by
// the proxy from now on, with each link's words and staging.
extern "C" int loam_peer_proxy(void* h, const int* fds) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  std::vector<int> socks;
  std::vector<LoamLink*> links;
  std::vector<char*> outs, ins;
  for (int t = 0; t < s->world; ++t) {
    if (s->island[t]) continue;
    if (fds[t] < 0) return (int)cudaErrorInvalidValue;
    socks.push_back(fds[t]);
    links.push_back(s->link[t]);
    outs.push_back(s->out_stage[t]);
    ins.push_back(s->in_stage[t]);
  }
  if (socks.empty() || s->proxy) return (int)cudaErrorInvalidValue;
  s->proxy = loam_proxy_start((int)socks.size(), socks.data(), links.data(), outs.data(), ins.data(), s->window,
                              s->abort_word);
  return s->proxy ? 0 : (int)cudaErrorInitializationError;
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

// What this rank holds for the mesh: out[0] device bytes (the control
// words, every mailbox generation, the route tables), out[1] pinned host
// bytes (the remote peers' staging and words, the abort word).
extern "C" int loam_peer_bytes(void* h, unsigned long long* out) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  unsigned long long dev = s->ctl ? control_bytes(s->isl_n) : 0, pinned = s->abort_word ? 64 : 0;
  for (size_t g = 0; g < s->own.size(); ++g) {
    if (s->own[g]) dev += 2ull * s->isl_n * s->caps[g];
    if (s->routes[g]) dev += (unsigned long long)s->world * sizeof(Route);
  }
  for (int t = 0; t < s->world; ++t)
    if (s->link[t]) pinned += sizeof(LoamLink) + 4 * s->window;
  out[0] = dev;
  out[1] = pinned;
  return 0;
}

// The longest wait of any spin of this rank's kernels so far, in cycles of
// clock64, and the timeout in the same cycles (a synchronous read: after a
// run, never inside a capture).
extern "C" int loam_peer_max_wait(void* h, unsigned long long* out) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  out[0] = 0;
  out[1] = (unsigned long long)s->timeout_cycles;
  if (!s->ctl) return 0;
  return (int)cudaMemcpy(&out[0], &s->ctl->max_wait, sizeof(unsigned long long), cudaMemcpyDeviceToHost);
}

// Close every island peer's mapping here (first step of a release: the
// caller then waits for every rank to have closed its own before
// loam_peer_free).
extern "C" int loam_peer_close(void* h) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  cudaError_t first = cudaSuccess;
  for (int r = 0; r < s->world; ++r) {
    if (r == s->rank) continue;
    for (auto& gen : s->mapped) {
      if (!gen[r]) continue;
      cudaError_t err = cudaIpcCloseMemHandle(gen[r]);
      if (first == cudaSuccess) first = err;
      gen[r] = nullptr;
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
  for (size_t g = 0; g < s->own.size(); ++g) {
    if (s->own[g]) keep(cudaFree(s->own[g]));
    if (s->routes[g]) keep(cudaFree(s->routes[g]));
  }
  for (int t = 0; t < s->world; ++t) {
    if (s->out_stage[t]) keep(cudaFreeHost(s->out_stage[t]));
    if (s->in_stage[t]) keep(cudaFreeHost(s->in_stage[t]));
    if (s->link[t]) keep(cudaFreeHost(s->link[t]));
  }
  if (s->abort_word) keep(cudaFreeHost(s->abort_word));
  if (s->ctl) keep(cudaFree(s->ctl));
  delete s;
  return (int)first;
}

// How a collective is cut (loam_peer_run): out = {bytes a chunk, chunks,
// pieces, chunks a piece}. Gather: `total` the packed bytes a rank; sum:
// `total` a block's bytes, `L` the blocks a rank. cudaErrorInvalidValue
// where one chunk of it does not fit a remote peer's staging slot.
extern "C" int loam_peer_plan(void* h, int mode, long long total, long long L, long long* out) {
  LoamPeer* s = static_cast<LoamPeer*>(h);
  // a sum's slice: a block's bytes over the ranks, a multiple of 16
  const unsigned long long slice = (((unsigned long long)total + s->world - 1) / s->world + 15) / 16 * 16;
  // chunks of the payload (a gather) or of a slice (a sum): enough to give
  // every block of the card one, of 4 to 64 KB, but never more than the
  // flags (a sum: half of them a phase); a multiple of 16
  const unsigned long long space = mode == kGather ? (unsigned long long)total : slice;
  const unsigned long long flags = mode == kGather ? LOAM_PEER_CHUNKS : LOAM_PEER_CHUNKS / 2;
  const auto up16 = [](unsigned long long n) { return (n + 15) / 16 * 16; };
  unsigned long long chunk = up16((space + s->grid_max - 1) / s->grid_max);
  chunk = chunk > LOAM_PEER_CHUNK_MAX ? LOAM_PEER_CHUNK_MAX : chunk;
  chunk = chunk < LOAM_PEER_CHUNK_MIN ? LOAM_PEER_CHUNK_MIN : chunk;
  const unsigned long long fewest = up16((space + flags - 1) / flags);
  chunk = chunk < fewest ? fewest : chunk;
  const long long chunks = (long long)((space + chunk - 1) / chunk);
  long long per_piece = chunks < 1 ? 1 : chunks;
  if (s->remote && s->world > 1) {
    // what a remote peer's staging slot takes of a chunk: the chunk, or
    // its part of each of the L blocks and the sums
    const unsigned long long staged = mode == kGather ? chunk : (unsigned long long)(L + 1) * chunk;
    if (staged > s->window) return (int)cudaErrorInvalidValue;
    const long long fit = (long long)(s->window / staged);
    per_piece = fit < per_piece ? fit : per_piece;
  }
  out[0] = (long long)chunk;
  out[1] = chunks;
  out[2] = chunks < 1 ? 1 : (chunks + per_piece - 1) / per_piece;
  out[3] = per_piece;
  return 0;
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
  long long plan[4];
  const int bad = loam_peer_plan(h, mode, total, L, plan);
  if (bad) return bad;
  Job job;
  memset(&job, 0, sizeof(Job));
  job.world = s->world;
  job.rank = s->rank;
  job.mode = mode;
  job.dtype = dtype;
  job.nseg = nseg;
  job.total = (unsigned long long)total;
  job.L = (unsigned long long)(mode == kSum ? L : 1);
  job.slice = (((unsigned long long)total + s->world - 1) / s->world + 15) / 16 * 16;
  job.chunk = (unsigned long long)plan[0];
  job.chunks = (int)plan[1];
  job.pieces = (int)plan[2];
  job.piece_chunks = (int)plan[3];
  job.timeout_cycles = s->timeout_cycles;
  if (s->world > 1) {
    // the island's region holds the whole payload (a sum: L + 1 slices)
    const unsigned long long payload = mode == kGather ? job.total : (job.L + 1) * job.slice;
    if (s->own.empty() || payload > s->cap || !s->routes.back()) return (int)cudaErrorInvalidValue;
    job.route = s->routes.back();
    job.ctl = s->ctl;
    job.abort_word = s->abort_word;
  }
  for (int i = 0; i < nseg; ++i) {
    job.seg[i].src = reinterpret_cast<const char*>(segs[4 * i]);
    job.seg[i].dst = reinterpret_cast<char*>(segs[4 * i + 1]);
    job.seg[i].off = (unsigned long long)segs[4 * i + 2];
    job.seg[i].n = (unsigned long long)segs[4 * i + 3];
  }
  // a block a chunk of a piece, at most what the card holds at once; nothing
  // to move (every leaf empty) is still one launch of one block, so the
  // epochs stay in step
  const int g = job.piece_chunks > s->grid_max ? s->grid_max : (job.piece_chunks < 1 ? 1 : job.piece_chunks);
  peer_kernel<<<g, LOAM_PEER_THREADS, s->smem, stream>>>(job);
  return (int)cudaGetLastError();
}
