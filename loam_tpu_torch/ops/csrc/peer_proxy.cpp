// The host proxy of the mesh's cross-host leg (peer_link.h): a rank's
// threads that move the chunks its kernel stages for remote peers over TCP
// and land the peers' chunks in its own staging, so the kernel's collective
// needs no host node and a graph captures it anywhere (ops/peer_cuda.py).
//
// For each remote peer (a link: a connected TCP socket and its LoamLink),
// two threads, one a direction, so that no copy waits on another link's or
// on the other direction's:
//   send     polls out_flags: a flag above what was last sent for it is a
//            chunk, sent as one message (a 56-byte header, then the pieces
//            its out_desc names, read straight from the out staging); the
//            slot of the lower epoch first, so chunks go in epoch order;
//            ack_out above what was last sent: an acknowledgement message.
//            Idle for 2 ms, it sleeps 20 us a round;
//   receive  blocks on the socket: a chunk's header, then its pieces
//            straight into the in staging at the same offsets, then
//            in_flags[slot][k] = epoch (a release store: the bytes before
//            the flag); an acknowledgement: ack_in.
// The threads call no CUDA function and read and write only host memory:
// the card reads and writes the same words over PCIe (release and acquire
// at system scope on its side).
//
// A socket that fails or closes, a message that names a slot or a staging
// the rank does not have: the proxy stores 1 into the abort word, which the
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
#include <unistd.h>

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

struct Header {
  unsigned magic, type, k, slot;
  unsigned long long epoch, off, bytes, stride, meta;  // meta: (gen << 32) | pieces
};
static_assert(sizeof(Header) == 56, "the wire's header is 56 bytes");

struct Stage {
  char* out = nullptr;
  char* in = nullptr;
  unsigned long long cap = 0;
};

struct Link {
  int fd = -1;
  LoamLink* w = nullptr;
  unsigned long long sent[2][LOAM_PEER_CHUNKS] = {};  // the flag last sent, a slot and chunk
  unsigned long long ack_sent = 0;
  Stage stage[LOAM_PEER_GENS];
  std::atomic<int> ready[LOAM_PEER_GENS];
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

using Clock = std::chrono::steady_clock;

inline unsigned long long load(const unsigned long long* p) { return __atomic_load_n(p, __ATOMIC_ACQUIRE); }
inline void store(unsigned long long* p, unsigned long long v) { __atomic_store_n(p, v, __ATOMIC_RELEASE); }

inline size_t payload(const Header& h) { return (size_t)h.bytes * (size_t)(h.meta & 0xffffffffu); }

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

// where the pieces of a chunk start in a staging slot (*at), or why not:
// later where the header's generation is not registered yet (a peer may
// send its first chunks before this rank's registration ends), bad where it
// names a generation, slot or range the staging cannot have
enum Where { kHere, kLater, kBad };

Where slot_base(Link& L, const Header& h, bool out, char** at) {
  const unsigned gen = (unsigned)(h.meta >> 32), pieces = (unsigned)(h.meta & 0xffffffffu);
  if (gen >= LOAM_PEER_GENS || h.slot > 1 || h.k >= LOAM_PEER_CHUNKS) return kBad;
  if (!L.ready[gen].load(std::memory_order_acquire)) return kLater;
  const Stage& s = L.stage[gen];
  const unsigned long long end = pieces ? h.off + (pieces - 1ull) * h.stride + h.bytes : h.off;
  if (end > s.cap || end < h.off) return kBad;
  *at = (out ? s.out : s.in) + h.slot * s.cap + h.off;
  return kHere;
}

// all n bytes, or false
bool send_all(int fd, const char* from, size_t n, bool more) {
  while (n) {
    const ssize_t got = send(fd, from, n, MSG_NOSIGNAL | (more ? MSG_MORE : 0));
    if (got < 0 && errno == EINTR) continue;
    if (got <= 0) return false;
    from += got;
    n -= (size_t)got;
  }
  return true;
}

bool send_message(Link& L, const Header& h, const char* base) {
  const unsigned pieces = (unsigned)(h.meta & 0xffffffffu);
  const bool body = h.type == kData && payload(h) > 0;
  if (!send_all(L.fd, reinterpret_cast<const char*>(&h), sizeof(h), body)) return false;
  for (unsigned j = 0; body && j < pieces; ++j)
    if (!send_all(L.fd, base + j * h.stride, h.bytes, j + 1 < pieces)) return false;
  return true;
}

// one link's sender: the raised flags in epoch order, then the acknowledgement
void send_loop(Proxy* p, size_t i) {
  Link& L = *p->links[i];
  auto last = Clock::now();
  while (!p->stop.load(std::memory_order_acquire) && !p->failed.load(std::memory_order_acquire)) {
    unsigned long long first[2] = {0, 0};  // a slot's epoch to send, 0: none
    for (int s = 0; s < 2; ++s) {
      if (!memcmp(L.w->out_flags[s], L.sent[s], sizeof(L.sent[s]))) continue;
      for (int k = 0; k < LOAM_PEER_CHUNKS; ++k) {
        const unsigned long long f = load(&L.w->out_flags[s][k]);
        if (f > L.sent[s][k]) {
          first[s] = f;
          break;
        }
      }
    }
    bool work = false;
    const int lower = first[1] && (!first[0] || first[1] < first[0]) ? 1 : 0;
    for (int s : {lower, 1 - lower}) {
      for (int k = 0; first[s] && k < LOAM_PEER_CHUNKS; ++k) {
        const unsigned long long f = load(&L.w->out_flags[s][k]);
        if (f <= L.sent[s][k]) continue;
        const unsigned long long* d = L.w->out_desc[s][k];
        const Header h{kMagic, kData, (unsigned)k, (unsigned)s, f, d[0], d[1], d[2], d[3]};
        char* base = nullptr;
        const Where where = slot_base(L, h, true, &base);
        if (where == kLater) continue;  // sent once its generation is registered
        if (where == kBad)
          return fail(p, i, "chunk " + std::to_string(k) + " of epoch " + std::to_string(f) +
                                " names a staging or range this rank does not have");
        if (!send_message(L, h, base)) return fail(p, i, std::string("send: ") + strerror(errno));
        L.sent[s][k] = f;
        work = true;
      }
    }
    const unsigned long long a = load(&L.w->ack_out);
    if (a > L.ack_sent) {
      if (!send_message(L, Header{kMagic, kAck, 0, 0, a, 0, 0, 0, 0}, nullptr))
        return fail(p, i, std::string("send: ") + strerror(errno));
      L.ack_sent = a;
      work = true;
    }
    if (work) {
      last = Clock::now();
    } else if (Clock::now() - last > std::chrono::milliseconds(2)) {
      std::this_thread::sleep_for(std::chrono::microseconds(20));
    }
  }
}

// all n bytes into `to`, or false (a closed socket: errno 0)
bool recv_all(int fd, char* to, size_t n) {
  while (n) {
    const ssize_t got = recv(fd, to, n, MSG_WAITALL);
    if (got < 0 && errno == EINTR) continue;
    if (got <= 0) {
      if (got == 0) errno = 0;
      return false;
    }
    to += got;
    n -= (size_t)got;
  }
  return true;
}

// one link's receiver: each message landed, then its flag or acknowledgement
void receive_loop(Proxy* p, size_t i) {
  Link& L = *p->links[i];
  const auto lost = [p, i](const char* what) {
    fail(p, i, errno ? std::string(what) + ": " + strerror(errno) : "the peer closed its socket");
  };
  while (!p->stop.load(std::memory_order_acquire)) {
    Header h;
    if (!recv_all(L.fd, reinterpret_cast<char*>(&h), sizeof(h))) return lost("recv");
    if (h.magic != kMagic || (h.type != kData && h.type != kAck))
      return fail(p, i, "a message that is not the proxy's");
    if (h.type == kAck) {
      if (h.epoch > load(&L.w->ack_in)) store(&L.w->ack_in, h.epoch);
    } else {
      char* base = nullptr;
      Where where;
      while ((where = slot_base(L, h, false, &base)) == kLater && !p->stop.load(std::memory_order_acquire))
        std::this_thread::sleep_for(std::chrono::microseconds(20));  // its generation is being registered
      if (where != kHere) {
        if (where == kBad)
          fail(p, i, "chunk " + std::to_string(h.k) + " of epoch " + std::to_string(h.epoch) +
                         " names a staging or range this rank does not have");
        return;
      }
      const unsigned pieces = (unsigned)(h.meta & 0xffffffffu);
      for (unsigned j = 0; h.bytes && j < pieces; ++j)
        if (!recv_all(L.fd, base + j * h.stride, h.bytes)) return lost("recv");
      store(&L.w->in_flags[h.slot][h.k], h.epoch);  // after its bytes
    }
  }
}

}  // namespace

extern "C" int loam_proxy_link_bytes(void) { return (int)sizeof(LoamLink); }

// A proxy over n links: fds[i] a connected TCP socket (the proxy owns it from
// now on and closes it at the stop), links[i] its words, abort_word the word
// it raises on a failure. Null where n < 1.
extern "C" void* loam_proxy_start(int n, const int* fds, LoamLink* const* links, unsigned long long* abort_word) {
  if (n < 1 || !abort_word) return nullptr;
  Proxy* p = new Proxy;
  p->abort_word = abort_word;
  for (int i = 0; i < n; ++i) {
    std::unique_ptr<Link> L(new Link);
    L->fd = fds[i];
    L->w = links[i];
    for (auto& r : L->ready) r.store(0);
    // the flags already up are not this proxy's to send (a fresh link has none)
    memcpy(L->sent, L->w->out_flags, sizeof(L->sent));
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

// Mailbox generation `gen`'s staging of link i: out and in, two slots of
// `cap` bytes each. Registered before this rank's kernel uses it (a peer's
// chunks of it may arrive first: they wait for it).
extern "C" int loam_proxy_stage(void* h, int gen, int i, char* out, char* in, unsigned long long cap) {
  Proxy* p = static_cast<Proxy*>(h);
  if (!p || gen < 0 || gen >= LOAM_PEER_GENS || i < 0 || i >= (int)p->links.size()) return 1;
  Link& L = *p->links[i];
  L.stage[gen].out = out;
  L.stage[gen].in = in;
  L.stage[gen].cap = cap;
  L.ready[gen].store(1, std::memory_order_release);
  return 0;
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
