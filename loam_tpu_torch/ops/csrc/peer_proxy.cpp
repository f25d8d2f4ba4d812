// The host proxy of the mesh's cross-host leg (peer_link.h): a rank's
// threads that move the chunks its kernel stages for remote peers over TCP
// and land the peers' chunks in its own staging, so the kernel's collective
// needs no host node and a graph captures it anywhere (ops/peer_cuda.py).
//
// For each remote peer (a link: a connected TCP socket and its LoamLink),
// two threads, one a direction, so that no copy waits on another link's or
// on the other direction's:
//   send     an acknowledgement first (ack_out above what was last sent: a
//            header alone), then a run: consecutive chunks of one slot and
//            epoch whose flags are up, found from a cursor a slot and half
//            of the flags (a gather's chunks count from flag 0, a sum's
//            first phase from 0 and its second from LOAM_PEER_CHUNKS / 2;
//            a half's chunks of an epoch are raised from its first flag
//            on, so the cursor starts there when that flag names a newer
//            epoch), the slot of the lower epoch first and, in one
//            epoch, the two halves in turn. A run's chunks lie
//            a fixed step apart in each of its pieces (a gather's and a
//            sum's second phase: one contiguous range; a sum's first
//            phase: L ranges a stride apart), every one full but the last
//            that holds bytes; it ends at the first flag not up, at a
//            chunk that does not continue it, or at kRunBytes. One
//            message: a header naming the slot, epoch, first chunk, count
//            and byte ranges, then the bytes chunk by chunk, each chunk's
//            pieces in order, in one sendmsg of an iovec a piece read
//            straight from the out staging. Idle, it spins for 2 ms over
//            the proxy's links (2 ms / links a link, at least 100 us: a
//            rank of many remote peers does not keep a core a link busy),
//            then sleeps a round 20 us, from 20 ms idle 100 us and from
//            200 ms 1 ms (24 ranks on a machine are hundreds of senders);
//   receive  blocks on the socket: a header, then a run's bytes straight
//            into the in staging at the same offsets, kLandBytes at a
//            time (a recvmsg over their pieces), each landing's chunks'
//            in_flags[slot][k] = epoch after its bytes (a release store);
//            an acknowledgement: ack_in.
// The threads call no CUDA function and read and write only host memory:
// the card reads and writes the same words over PCIe (release and acquire
// at system scope on its side). A run needs no order against the
// acknowledgements: the peer acknowledges epoch e only after every chunk of
// e arrived, so the kernel rewrites a slot only after its proxy sent it.
//
// Each direction of a link counts its messages, chunks, payload bytes and
// acknowledgements, its send / recv calls and the time blocked in them, the
// time spent finding runs and the time asleep (loam_proxy_counters).
//
// A socket that fails or closes, a message that names a slot or a range
// the staging does not have: the proxy stores 1 into the abort word, which the
// kernel's spin reads (it traps, and the call raises), and keeps the reason
// (loam_proxy_failed). The stop shuts the sockets down, which ends every
// thread's blocking call, and joins them.
//
// Builds with nvcc (linked into the kernel library, _build.SOURCES) and
// with a plain C++17 compiler (tests/test_torch_cross_host.py drives it in
// two processes over loopback).

#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "peer_link.h"

namespace {

constexpr unsigned kMagic = 0x4c4f414du;  // "LOAM"
enum : unsigned { kData = 1, kAck = 2 };
constexpr int kHalf = LOAM_PEER_CHUNKS / 2;  // a cursor's flags
// a run's payload at most (a large collective's first chunks do not wait
// behind all of it), and a landing's
constexpr unsigned long long kRunBytes = 4ull << 20, kLandBytes = 1ull << 20;
constexpr int kIov = 512;  // iovec entries a call at most (IOV_MAX is 1024)

// a run: chunks k .. k + count - 1 of slot `slot`, epoch `epoch`; chunk i's
// piece j is bytes [off + j * stride + i * step, + its bytes) of the slot,
// a chunk's bytes min(step, bytes - i * step), none past `bytes`
struct Header {
  unsigned magic, type, slot, k;
  unsigned count, pieces, pad0, pad1;
  unsigned long long epoch, off, step, bytes, stride;
};
static_assert(sizeof(Header) == 72, "the wire's header is 72 bytes");

// what a link's direction did (loam_proxy_counters), written by its one
// thread and read by any: messages (data), chunks and payload bytes they
// carried, acknowledgements, send / recv calls and the nanoseconds blocked
// in them, nanoseconds finding runs (the sender) and asleep
enum { kMessages, kChunks, kBytes, kAcks, kSyscalls, kBlockedNs, kScanNs, kSleepNs, kCounters };

struct Counters {
  std::atomic<unsigned long long> v[kCounters] = {};
  void add(int i, unsigned long long n) { v[i].fetch_add(n, std::memory_order_relaxed); }
};

using Clock = std::chrono::steady_clock;

inline unsigned long long ns_since(Clock::time_point t0) {
  return (unsigned long long)std::chrono::duration_cast<std::chrono::nanoseconds>(Clock::now() - t0).count();
}

struct Stage {
  char* out = nullptr;
  char* in = nullptr;
  unsigned long long cap = 0;
};

// where a slot and half's chunks were last sent: epoch e up to chunk k
struct Cursor {
  unsigned long long e = 0;
  int k = 0;
};

struct Link {
  int fd = -1;
  LoamLink* w = nullptr;
  Counters out, in;  // the sender's, the receiver's
  Cursor cur[2][2];  // [slot][half]
  int last_half = 1;  // the half of the last run sent
  unsigned long long ack_sent = 0;
  Stage stage;
  std::thread sender, receiver;
};

struct Proxy {
  std::vector<std::unique_ptr<Link>> links;
  unsigned long long* abort_word = nullptr;
  std::atomic<bool> stop{false};
  std::atomic<int> failed{0};  // 1 + the failed link's index
  std::mutex error_mu;
  std::string error;
};

inline unsigned long long load(const unsigned long long* p) { return __atomic_load_n(p, __ATOMIC_ACQUIRE); }
inline void store(unsigned long long* p, unsigned long long v) { __atomic_store_n(p, v, __ATOMIC_RELEASE); }

// chunk i's bytes in each piece of run h
inline unsigned long long chunk_bytes(const Header& h, unsigned i) {
  const unsigned long long lo = (unsigned long long)i * h.step;
  return lo >= h.bytes ? 0 : (h.bytes - lo < h.step ? h.bytes - lo : h.step);
}

// the first failure: its reason kept, the abort word raised (none once the
// proxy stops: its sockets are shut down on purpose)
void fail(Proxy* p, size_t i, const std::string& why) {
  if (p->stop.load(std::memory_order_acquire)) return;
  std::lock_guard<std::mutex> hold(p->error_mu);
  if (p->failed.load()) return;
  p->error = "link " + std::to_string(i) + ": " + why;
  p->failed.store(1 + (int)i, std::memory_order_release);
  store(p->abort_word, 1);
}

// where run h's slot starts in the staging (*at), or false where it names
// a slot, chunk or range the staging cannot have
bool slot_base(Link& L, const Header& h, bool out, char** at) {
  if (h.slot > 1 || h.k >= LOAM_PEER_CHUNKS || h.count < 1 || h.count > LOAM_PEER_CHUNKS - h.k || h.pieces < 1 ||
      h.pieces > (1u << 20))
    return false;
  if (h.bytes > h.step * h.count || (h.bytes && h.step == 0)) return false;  // every byte in a chunk
  const Stage& s = L.stage;
  const unsigned long long span = (h.pieces - 1ull) * h.stride;
  if (h.stride && span / h.stride != h.pieces - 1ull) return false;
  const unsigned long long end = h.off + span + h.bytes;
  if (end > s.cap || end < h.off) return false;
  *at = (out ? s.out : s.in) + h.slot * s.cap;
  return true;
}

// run h's pieces from chunk i0 to i1, as iovec entries over the slot at
// base (adjacent ones merged) appended to v
void pieces(const Header& h, char* base, unsigned i0, unsigned i1, std::vector<iovec>& v) {
  for (unsigned i = i0; i < i1; ++i) {
    const unsigned long long n = chunk_bytes(h, i);
    for (unsigned j = 0; n && j < h.pieces; ++j) {
      char* at = base + h.off + j * h.stride + (unsigned long long)i * h.step;
      if (!v.empty() && (char*)v.back().iov_base + v.back().iov_len == at)
        v.back().iov_len += n;
      else
        v.push_back(iovec{at, (size_t)n});
    }
  }
}

// past n bytes of iovec list v from entry *i on
void advance(std::vector<iovec>& v, size_t* i, size_t n) {
  while (n && *i < v.size()) {
    const size_t take = n < v[*i].iov_len ? n : v[*i].iov_len;
    v[*i].iov_base = (char*)v[*i].iov_base + take;
    v[*i].iov_len -= take;
    n -= take;
    if (v[*i].iov_len == 0) ++*i;
  }
}

// every byte of v, kIov entries a sendmsg at most, or false
bool send_all(int fd, std::vector<iovec>& v, Counters& c) {
  size_t i = 0;
  while (i < v.size()) {
    if (v[i].iov_len == 0) {
      ++i;
      continue;
    }
    msghdr m{};
    m.msg_iov = &v[i];
    m.msg_iovlen = v.size() - i < (size_t)kIov ? v.size() - i : (size_t)kIov;
    const auto t0 = Clock::now();
    const ssize_t got = sendmsg(fd, &m, MSG_NOSIGNAL);
    c.add(kSyscalls, 1);
    c.add(kBlockedNs, ns_since(t0));
    if (got < 0 && errno == EINTR) continue;
    if (got <= 0) return false;
    advance(v, &i, (size_t)got);
  }
  return true;
}

// every byte of v into place, or false (a closed socket: errno 0)
bool recv_all(int fd, std::vector<iovec>& v, Counters& c) {
  size_t i = 0;
  while (i < v.size()) {
    if (v[i].iov_len == 0) {
      ++i;
      continue;
    }
    msghdr m{};
    m.msg_iov = &v[i];
    m.msg_iovlen = v.size() - i < (size_t)kIov ? v.size() - i : (size_t)kIov;
    const auto t0 = Clock::now();
    const ssize_t got = recvmsg(fd, &m, MSG_WAITALL);
    c.add(kSyscalls, 1);
    c.add(kBlockedNs, ns_since(t0));
    if (got < 0 && errno == EINTR) continue;
    if (got <= 0) {
      if (got == 0) errno = 0;
      return false;
    }
    advance(v, &i, (size_t)got);
  }
  return true;
}

// The run that starts at cursor c of slot s, half `half`, if one is up:
// its epoch's first flag not yet sent; a newer epoch's first flag moves
// the cursor to it. False where nothing is up.
bool run_start(Link& L, int s, int half, Cursor* c) {
  const int base = half * kHalf, end = base + kHalf;
  const unsigned long long* f = L.w->out_flags[s];
  if (c->k < end && c->e && load(&f[c->k]) == c->e) return true;
  const unsigned long long first = load(&f[base]);
  if (first > c->e) {
    c->e = first;
    c->k = base;
    return true;
  }
  return false;
}

// the run from cursor c: the longest that continues (above) within the caps
Header run_at(Link& L, int s, int half, const Cursor& c) {
  const int end = (half + 1) * kHalf;
  const unsigned long long* f = L.w->out_flags[s];
  const unsigned long long* d = L.w->out_desc[s][c.k];
  Header h{kMagic, kData, (unsigned)s, (unsigned)c.k, 1, (unsigned)d[3], 0, 0, c.e, d[0], d[1] ? d[1] : 1, d[1], d[2]};
  const unsigned long long pieces = h.pieces ? h.pieces : 1;
  for (int k = c.k + 1; k < end; ++k) {
    if (load(&f[k]) != c.e) break;
    const unsigned long long* n = L.w->out_desc[s][k];
    const unsigned i = h.count;
    if (n[2] != d[2] || n[3] != d[3] || n[1] > (i == 1 ? n[0] - d[0] : h.step)) break;
    if (i == 1) {  // the second chunk sets the step: the first one full
      if (n[0] <= d[0] || d[1] != n[0] - d[0]) break;
      h.step = n[0] - d[0];
    } else if (n[0] != d[0] + i * h.step) {
      break;
    }
    if (h.bytes != i * h.step && n[1] != 0) break;  // a chunk after a short one is empty
    if ((h.bytes + n[1]) * pieces > kRunBytes) break;
    h.bytes += n[1];
    h.count = i + 1;
  }
  return h;
}

// one link's sender: the acknowledgement, then the raised runs in epoch order
void send_loop(Proxy* p, size_t i) {
  Link& L = *p->links[i];
  auto last = Clock::now();
  const auto spin = std::max(std::chrono::microseconds(100),
                             std::chrono::microseconds(2000 / (long)p->links.size()));
  std::vector<iovec> v;
  while (!p->stop.load(std::memory_order_acquire) && !p->failed.load(std::memory_order_acquire)) {
    bool work = false;
    const unsigned long long a = load(&L.w->ack_out);
    if (a > L.ack_sent) {
      Header h{kMagic, kAck, 0, 0, 0, 0, 0, 0, a, 0, 0, 0, 0};
      v.assign(1, iovec{&h, sizeof(h)});
      if (!send_all(L.fd, v, L.out)) return fail(p, i, std::string("send: ") + strerror(errno));
      L.out.add(kAcks, 1);
      L.ack_sent = a;
      work = true;
    }
    const auto scan0 = Clock::now();
    int best_s = -1, best_h = 0;
    for (int s = 0; s < 2; ++s)
      for (int half = 0; half < 2; ++half) {
        Cursor c = L.cur[s][half];
        if (!run_start(L, s, half, &c)) continue;
        L.cur[s][half] = c;
        const unsigned long long e = best_s < 0 ? 0 : L.cur[best_s][best_h].e;
        // the lower epoch; in one epoch the half not served last (a sum's
        // two phases take turns: the peer's second phase waits on ours)
        if (best_s < 0 || c.e < e || (c.e == e && half != L.last_half)) best_s = s, best_h = half;
      }
    if (best_s >= 0) {
      Cursor& c = L.cur[best_s][best_h];
      L.last_half = best_h;
      const Header h = run_at(L, best_s, best_h, c);
      L.out.add(kScanNs, ns_since(scan0));
      char* base = nullptr;
      if (!slot_base(L, h, true, &base))
        return fail(p, i, "chunks " + std::to_string(h.k) + " to " + std::to_string(h.k + h.count - 1) +
                              " of epoch " + std::to_string(h.epoch) + " name a range the staging does not have");
      v.assign(1, iovec{const_cast<Header*>(&h), sizeof(h)});
      pieces(h, base, 0, h.count, v);
      if (!send_all(L.fd, v, L.out)) return fail(p, i, std::string("send: ") + strerror(errno));
      L.out.add(kMessages, 1);
      L.out.add(kChunks, h.count);
      L.out.add(kBytes, h.bytes * h.pieces);
      c.k += (int)h.count;
      work = true;
    } else {
      L.out.add(kScanNs, ns_since(scan0));
    }
    if (work) {
      last = Clock::now();
    } else {
      const auto idle = Clock::now() - last;
      if (idle > spin) {
        const auto t0 = Clock::now();
        std::this_thread::sleep_for(idle < std::chrono::milliseconds(20)    ? std::chrono::microseconds(20)
                                    : idle < std::chrono::milliseconds(200) ? std::chrono::microseconds(100)
                                                                            : std::chrono::microseconds(1000));
        L.out.add(kSleepNs, ns_since(t0));
      }
    }
  }
}

// one link's receiver: each run landed a landing at a time, each landing's
// flags after its bytes; each acknowledgement into ack_in
void receive_loop(Proxy* p, size_t i) {
  Link& L = *p->links[i];
  const auto lost = [p, i](const char* what) {
    fail(p, i, errno ? std::string(what) + ": " + strerror(errno) : "the peer closed its socket");
  };
  std::vector<iovec> v;
  while (!p->stop.load(std::memory_order_acquire)) {
    Header h;
    v.assign(1, iovec{&h, sizeof(h)});
    if (!recv_all(L.fd, v, L.in)) return lost("recv");
    if (h.magic != kMagic || (h.type != kData && h.type != kAck))
      return fail(p, i, "a message that is not the proxy's");
    if (h.type == kAck) {
      if (h.epoch > load(&L.w->ack_in)) store(&L.w->ack_in, h.epoch);
      L.in.add(kAcks, 1);
      continue;
    }
    char* base = nullptr;
    if (!slot_base(L, h, false, &base))
      return fail(p, i, "chunks " + std::to_string(h.k) + " to " + std::to_string(h.k + h.count - 1) + " of epoch " +
                            std::to_string(h.epoch) + " name a range the staging does not have");
    for (unsigned i0 = 0; i0 < h.count;) {
      unsigned i1 = i0 + 1;
      unsigned long long n = chunk_bytes(h, i0) * h.pieces;
      while (i1 < h.count && n + chunk_bytes(h, i1) * h.pieces <= kLandBytes) n += chunk_bytes(h, i1++) * h.pieces;
      v.clear();
      pieces(h, base, i0, i1, v);
      if (!recv_all(L.fd, v, L.in)) return lost("recv");
      for (unsigned c = i0; c < i1; ++c) store(&L.w->in_flags[h.slot][h.k + c], h.epoch);  // after its bytes
      i0 = i1;
    }
    L.in.add(kMessages, 1);
    L.in.add(kChunks, h.count);
    L.in.add(kBytes, h.bytes * h.pieces);
  }
}

}  // namespace

extern "C" int loam_proxy_link_bytes(void) { return (int)sizeof(LoamLink); }

// A proxy over n links: fds[i] a connected TCP socket (the proxy owns it from
// now on and closes it at the stop), links[i] its words, outs[i] and ins[i]
// its staging (two slots of `cap` bytes each way), abort_word the word it
// raises on a failure. Null where n < 1.
extern "C" void* loam_proxy_start(int n, const int* fds, LoamLink* const* links, char* const* outs, char* const* ins,
                                  unsigned long long cap, unsigned long long* abort_word) {
  if (n < 1 || !abort_word) return nullptr;
  Proxy* p = new Proxy;
  p->abort_word = abort_word;
  for (int i = 0; i < n; ++i) {
    std::unique_ptr<Link> L(new Link);
    L->fd = fds[i];
    L->w = links[i];
    L->stage = Stage{outs[i], ins[i], cap};
    // the flags already up are not this proxy's to send (a fresh link has none)
    for (int s = 0; s < 2; ++s)
      for (int half = 0; half < 2; ++half)
        L->cur[s][half] = Cursor{load(&L->w->out_flags[s][half * kHalf]), (half + 1) * kHalf};
    const int one = 1, buf = 8 << 20;
    fcntl(L->fd, F_SETFL, fcntl(L->fd, F_GETFL) & ~O_NONBLOCK);  // each thread blocks on its own direction
    setsockopt(L->fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    setsockopt(L->fd, SOL_SOCKET, SO_SNDBUF, &buf, sizeof(buf));
    setsockopt(L->fd, SOL_SOCKET, SO_RCVBUF, &buf, sizeof(buf));
    p->links.push_back(std::move(L));
  }
  for (size_t i = 0; i < p->links.size(); ++i) {
    p->links[i]->sender = std::thread(send_loop, p, i);
    p->links[i]->receiver = std::thread(receive_loop, p, i);
  }
  return p;
}

// Link i's counters into out: the sender's kCounters words, then the
// receiver's (the enum above). Returns kCounters, or -1 for no such link.
extern "C" int loam_proxy_counters(void* h, int i, unsigned long long* out) {
  Proxy* p = static_cast<Proxy*>(h);
  if (!p || i < 0 || i >= (int)p->links.size()) return -1;
  const Link& L = *p->links[i];
  for (int k = 0; k < kCounters; ++k) {
    out[k] = L.out.v[k].load(std::memory_order_relaxed);
    out[kCounters + k] = L.in.v[k].load(std::memory_order_relaxed);
  }
  return kCounters;
}

// 0 while every link is well; else 1 + the failed link's index, and the
// reason into msg.
extern "C" int loam_proxy_failed(void* h, char* msg, int len) {
  Proxy* p = static_cast<Proxy*>(h);
  const int f = p ? p->failed.load(std::memory_order_acquire) : 0;
  if (f && msg && len > 0) {
    std::lock_guard<std::mutex> hold(p->error_mu);
    strncpy(msg, p->error.c_str(), (size_t)len - 1);
    msg[len - 1] = 0;
  }
  return f;
}

// Stop the threads (the sockets shut down end their blocking calls), join
// them, close the sockets, free the proxy.
extern "C" int loam_proxy_stop(void* h) {
  Proxy* p = static_cast<Proxy*>(h);
  if (!p) return 0;
  p->stop.store(true, std::memory_order_release);
  for (auto& L : p->links) shutdown(L->fd, SHUT_RDWR);
  for (auto& L : p->links) {
    if (L->sender.joinable()) L->sender.join();
    if (L->receiver.joinable()) L->receiver.join();
    close(L->fd);
  }
  delete p;
  return 0;
}
