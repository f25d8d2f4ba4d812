// The cross-host leg of the mesh's collectives: the words that a rank's
// kernel (peer_gather.cu) and its host proxy (peer_proxy.cpp) share for one
// remote peer. They live in pinned host memory, mapped for the card
// (cudaHostAlloc); the proxy touches them with plain CPU loads and stores
// and calls no CUDA function, so this header includes no CUDA header and the
// proxy builds with a plain C++ compiler too.
//
// Per remote peer and per slot s (epoch e uses slot e & 1, as the device
// mailbox does):
//   out_flags[s][k]  the kernel stores e here (release, system scope) once
//                    chunk k of epoch e is in the out staging of slot s and
//                    out_desc[s][k] says where; the proxy sends it, with
//                    the consecutive chunks raised beside it (a run). An
//                    epoch's chunks take flags 0, 1, ... of a half (a
//                    gather's from 0 on, past LOAM_PEER_CHUNKS / 2 too; a
//                    sum's first phase from 0, its second from
//                    LOAM_PEER_CHUNKS / 2)
//   out_desc[s][k]   {offset, bytes a piece, stride, pieces}: the chunk's
//                    pieces, at offset + j * stride of the slot (a sum's
//                    first phase sends L pieces a chunk). The staging is
//                    two slots of a fixed window each way, made with the
//                    mesh; the kernel sends a collective that outgrows a
//                    slot in pieces, an epoch each
//   in_flags[s][k]   the proxy stores e here once the peer's chunk k of
//                    epoch e is in the in staging of slot s; the kernel
//                    waits on it
//   ack_out          the kernel's last finished epoch, for the peer; the
//                    proxy sends it on
//   ack_in           the peer's last finished epoch, as the proxy got it
// A flag a slot, not a flag a chunk: the kernel may raise chunk k of epoch
// e + 1 before the proxy has sent chunk k of epoch e, and each must still be
// sent. Slot s is written again at e + 2 only after the peer's ack of e, which
// the peer sends only after every chunk of e arrived, so the proxy has sent
// every chunk of slot s before the kernel rewrites it.

#ifndef LOAM_PEER_LINK_H
#define LOAM_PEER_LINK_H

#define LOAM_PEER_CHUNKS 4096  // flags a sender (and slot); a sum's two phases take half each

struct LoamLink {
  unsigned long long out_flags[2][LOAM_PEER_CHUNKS];
  unsigned long long out_desc[2][LOAM_PEER_CHUNKS][4];
  unsigned long long in_flags[2][LOAM_PEER_CHUNKS];
  unsigned long long ack_out;
  unsigned long long ack_in;
};

#ifdef __cplusplus
extern "C" {
#endif
// peer_proxy.cpp's interface (ops/peer_cuda.py; tests/test_torch_cross_host.py
// drives it alone)
void* loam_proxy_start(int n, const int* fds, struct LoamLink* const* links, char* const* outs, char* const* ins,
                       unsigned long long cap, unsigned long long* abort_word);
int loam_proxy_failed(void* proxy, char* msg, int len);
int loam_proxy_counters(void* proxy, int link, unsigned long long* out);
int loam_proxy_stop(void* proxy);
int loam_proxy_link_bytes(void);
#ifdef __cplusplus
}
#endif

#endif
