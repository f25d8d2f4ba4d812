"""The mesh across hosts, on the CPU: the host grouping, the host proxy of
the cross-host leg, and a gloo mesh labelled as two hosts.

  * ``peer_cuda.islands``: the islands a mesh's host labels and its cards'
    reach give, asking the reach only of ranks with one label (identical
    servers share PCI bus ids: cards of two machines are never compared),
    and ``check_hosts``'s refusals; 24 labels (3 hosts of 8, and 2 hosts
    of 12 whose cards reach within pairs), past the kernel's old cap of 16.
  * ``csrc/peer_proxy.cpp`` built with ``g++`` and driven in two processes
    over loopback TCP (this file as the worker,
    ``python tests/test_torch_cross_host.py proxy <rank> <port> <lib> <out>``):
    each process stands in for a rank's kernel, writing chunks into its out
    staging, their descriptions and flags into the words of
    ``csrc/peer_link.h`` as the kernel does (the bytes, then the
    description, then the flag; an epoch's chunks of each half of the flags
    dense from its first), over 7 epochs (each slot rewritten after the
    peer's acknowledgement of the epoch before last), gathers and sums by
    turns, flags raised in a shuffled order and
    chunks of one piece, of several pieces a stride apart (a sum's first
    phase), short, empty and one that does not continue the chunk before
    (a run ends there); every byte the peer's proxy lands, every flag and
    every acknowledgement is checked, and the counters (every chunk and
    byte sent and received, in at most as many messages); then one process
    leaves without stopping its proxy, and the other's proxy must raise
    the abort word and name the closed socket.
  * In one process over a socket pair: a gather's run of 40 chunks and a
    sum's strided first phase and contiguous second phase each cross as
    one message in one ``sendmsg`` and land at their offsets with every
    flag raised (the counters show it); a peer that closes its socket in
    the middle of a run raises the abort word, no flag of the run up.
  * Two proxies of one process over 20 links (socket pairs), more than
    the 16 remote peers of a rank of 24 on 3 hosts of 8: every link's
    chunks, bytes and acknowledgement, both ways, landed and counted.
  * 4 gloo ranks of ``tests/test_torch_multiprocess.py``'s harness with
    ``make_mesh(hosts=[0, 0, 1, 1])``: its islands, and
    ``scan_to_map_step_sharded`` bit-equal to 1 rank x 4 shards.
"""

import ctypes
import json
import os
import random
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

from loam_tpu_torch.ops.peer_cuda import check_hosts, islands, machine

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(os.path.dirname(_HERE), "loam_tpu_torch", "ops", "csrc")
CHUNKS = 4096  # LOAM_PEER_CHUNKS
EPOCHS = 7
TIMEOUT_S = 60


# ---- the host grouping ------------------------------------------------------------------


def _reach_within(labels, pairs):
    """A reach that only ranks of one label may be asked about: True for
    the ``pairs`` (both ways), else False."""
    def reach(a, b):
        assert labels[a] == labels[b], f"asked whether ranks {a} and {b} of two hosts reach each other"
        return (a, b) in pairs or (b, a) in pairs or a == b
    return reach


@pytest.mark.parametrize("labels,pairs,want", [
    # two identical servers (the same bus ids on each): two islands, never compared across
    (("A", "A", "B", "B"), {(0, 1), (2, 3)}, ((0, 1), (2, 3))),
    # one host whose cards all reach each other
    (("A",) * 4, {(a, b) for a in range(4) for b in range(4)}, ((0, 1, 2, 3),)),
    # four hosts of one rank each (chip_smoke.py's 4 x 1)
    (("0", "1", "2", "3"), set(), ((0,), (1,), (2,), (3,))),
    # ranks of a host interleaved with another's: an island keeps rank order
    (("A", "B", "A", "B"), {(0, 2), (1, 3)}, ((0, 2), (1, 3))),
    # one host, two pairs of cards that reach within the pair only
    (("A",) * 4, {(0, 1), (2, 3)}, ((0, 1), (2, 3))),
    # a card that reaches only some of an island starts its own
    (("A",) * 3, {(0, 1), (1, 2)}, ((0, 1), (2,))),
    # 24 ranks of 3 hosts of 8, past the kernel's old cap of 16: an island a host
    (tuple(str(r // 8) for r in range(24)), {(a, b) for a in range(24) for b in range(24) if a // 8 == b // 8},
     tuple(tuple(range(h * 8, h * 8 + 8)) for h in range(3))),
    # 24 ranks of 2 hosts whose cards reach within pairs of cards only (6 ranks a card: rank r on card r % 4)
    (tuple(str(r // 12) for r in range(24)),
     {(a, b) for a in range(24) for b in range(24) if a // 12 == b // 12 and (a % 4) // 2 == (b % 4) // 2},
     tuple(tuple(r for r in range(h * 12, h * 12 + 12) if (r % 4) // 2 == pair) for h in range(2) for pair in (0, 1))),
])
def test_islands_follow_hosts_and_reach(labels, pairs, want):
    assert islands(labels, _reach_within(labels, pairs)) == want


def test_hosts_labels_and_machine():
    """One label a rank, any values, as strings; a wrong count raises; this
    machine is its host name and boot id."""
    assert check_hosts([0, 0, 1, 1], 4) == ("0", "0", "1", "1")
    with pytest.raises(ValueError, match="one a rank"):
        check_hosts([0, 1], 4)
    name, boot = machine().split("/", 1)
    assert name == socket.gethostname() and boot


# ---- the proxy, two processes over loopback ----------------------------------------------

HALF = CHUNKS // 2  # a sum's second phase counts its flags from here
# an epoch's chunks as the kernel raises them: (flag index, offset, bytes a
# piece, stride, pieces), each half's from its first flag on. A gather's
# payload: chunks a step apart, the last short (and one more from epoch 4
# on), with a break where a chunk does not continue the one before (a run
# ends there); a sum's first phase: 3 pieces a stride apart, the last chunk
# short then an empty one; its second phase: contiguous from flag HALF on
_C, _S = 1000, 8192
_GATHER = [(k, k * _C, _C, 0, 1) for k in range(3)] + [(3, 5000, 700, 0, 1), (4, 5700, 300, 0, 1)]
_SUM = ([(k, k * _C, _C, _S, 3) for k in range(3)] + [(3, 3000, 500, _S, 3), (4, 4000, 0, _S, 3)] +
        [(HALF + k, 3 * _S + k * _C, _C, 0, 1) for k in range(4)])
_CAP = 256 << 10  # bytes a staging slot
_BIG = (5, 70000, 150000, 0, 1)  # a gather's chunk after chunk 4's end: a new run


def _chunks(e: int) -> list:
    if e % 2 == 0:
        return _SUM
    return _GATHER + ([_BIG] if e >= 4 else [])


def _bytes(rank: int, e: int, k: int, j: int, n: int) -> np.ndarray:
    return ((rank * 131 + e * 31 + k * 7 + j * 3 + np.arange(n)) % 251).astype(np.uint8)


def _wait(cond, what: str) -> None:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > TIMEOUT_S:
            raise TimeoutError(what)
        time.sleep(1e-4)


def _load_proxy(lib_path: str):
    lib = ctypes.CDLL(lib_path)
    lib.loam_proxy_start.restype = ctypes.c_void_p
    lib.loam_proxy_start.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.c_ulonglong, ctypes.c_void_p]
    lib.loam_proxy_failed.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.loam_proxy_counters.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong)]
    lib.loam_proxy_stop.argtypes = [ctypes.c_void_p]
    return lib


class _Words:
    """A link's words (``csrc/peer_link.h``) in a numpy array, as the card
    sees them: out flags, chunk descriptions, in flags, two acks."""

    def __init__(self, lib):
        words = lib.loam_proxy_link_bytes() // 8
        assert words == 2 * CHUNKS * 6 + 2, words
        self.link = np.zeros(words, dtype=np.uint64)
        self.out_flags = self.link[:2 * CHUNKS].reshape(2, CHUNKS)
        self.out_desc = self.link[2 * CHUNKS:10 * CHUNKS].reshape(2, CHUNKS, 4)
        self.in_flags = self.link[10 * CHUNKS:12 * CHUNKS].reshape(2, CHUNKS)
        self.acks = self.link[12 * CHUNKS:]  # ack_out, ack_in
        self.abort = np.zeros(1, dtype=np.uint64)

    def start(self, lib, fd: int, cap: int):
        """A proxy of this one link, with a staging of two slots of ``cap``
        bytes each way (``self.stage``: out, in)."""
        self.stage = (np.zeros(2 * cap, dtype=np.uint8), np.zeros(2 * cap, dtype=np.uint8))
        one = lambda x: (ctypes.c_void_p * 1)(x.ctypes.data)
        return lib.loam_proxy_start(1, (ctypes.c_int * 1)(fd), one(self.link), one(self.stage[0]),
                                    one(self.stage[1]), cap, self.abort.ctypes.data)


def _counters(lib, proxy) -> dict:
    """The proxy's counters of its one link (``peer_cuda.LINK_COUNTERS``'s
    order), by direction."""
    from loam_tpu_torch.ops.peer_cuda import LINK_COUNTERS

    raw = (ctypes.c_ulonglong * (2 * len(LINK_COUNTERS)))()
    assert lib.loam_proxy_counters(proxy, 0, raw) == len(LINK_COUNTERS)
    n = len(LINK_COUNTERS)
    return {side: dict(zip(LINK_COUNTERS, raw[j * n:(j + 1) * n])) for j, side in enumerate(("send", "recv"))}


def _proxy_worker(rank: int, port: int, lib_path: str, out: str) -> None:
    """One side of the proxy test (the module docstring)."""
    lib = _load_proxy(lib_path)
    w = _Words(lib)
    if rank == 0:
        listener = socket.socket()
        listener.bind(("127.0.0.1", port))
        listener.listen(1)
        listener.settimeout(TIMEOUT_S)
        sock, _ = listener.accept()
        listener.close()
    else:
        t0 = time.perf_counter()
        while True:
            try:
                sock = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT_S)
                break
            except ConnectionRefusedError:
                if time.perf_counter() - t0 > TIMEOUT_S:
                    raise
                time.sleep(0.05)
    proxy = w.start(lib, sock.detach(), _CAP)
    stage, cap = w.stage, _CAP
    rng = random.Random(rank)
    peer, checked, chunks = 1 - rank, 0, 0
    for e in range(1, EPOCHS + 1):
        slot = e & 1
        if e > 2:  # the credit: the peer read this slot at e - 2
            _wait(lambda: w.acks[1] >= e - 2, f"the peer's acknowledgement of epoch {e - 2}")
        plan = _chunks(e)
        for k, off, n, stride, pieces in rng.sample(plan, len(plan)):
            for j in range(pieces):
                at = slot * cap + off + j * stride
                stage[0][at:at + n] = _bytes(rank, e, k, j, n)
            w.out_desc[slot, k] = (off, n, stride, pieces)
            w.out_flags[slot, k] = e  # after the bytes and the description
        for k, off, n, stride, pieces in plan:
            _wait(lambda: w.in_flags[slot, k] >= e, f"the peer's chunk {k} of epoch {e}")
            assert w.in_flags[slot, k] == e
            for j in range(pieces):
                at = slot * cap + off + j * stride
                got = stage[1][at:at + n]
                assert np.array_equal(got, _bytes(peer, e, k, j, n)), (e, k, j)
                checked += n
        chunks += len(plan)
        w.acks[0] = e
    _wait(lambda: w.acks[1] >= EPOCHS, "the peer's last acknowledgement")
    msg = ctypes.create_string_buffer(256)
    clean = int(w.abort[0]) == 0 and lib.loam_proxy_failed(proxy, msg, 256) == 0
    # the peer's chunks all counted (the receiver counts a run after its flags)
    _wait(lambda: _counters(lib, proxy)["recv"]["chunks"] >= chunks, "the peer's chunks counted")
    result = {"checked": checked, "chunks": chunks, "clean": clean, "acks": [int(a) for a in w.acks],
              "counters": _counters(lib, proxy)}
    if rank == 1:
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
        time.sleep(0.5)  # its proxy sends the last acknowledgement on
        os._exit(0)  # leaves with its proxy running: the socket closes under it
    _wait(lambda: w.abort[0] == 1, "the abort word after the peer left")
    failed = lib.loam_proxy_failed(proxy, msg, 256)
    result.update(abort=int(w.abort[0]), failed=failed, why=msg.value.decode())
    lib.loam_proxy_stop(proxy)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


@pytest.fixture(scope="module")
def proxy_lib(tmp_path_factory):
    """``csrc/peer_proxy.cpp`` built with ``g++`` (no CUDA)."""
    lib = tmp_path_factory.mktemp("proxy") / "peer_proxy.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-fPIC", "-shared", "-pthread", "-o", str(lib),
                    os.path.join(_CSRC, "peer_proxy.cpp")], check=True)
    return str(lib)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_proxy_moves_every_chunk_and_ack_and_raises_on_a_lost_peer(tmp_path, proxy_lib):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(_HERE) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "proxy", str(r), str(port), proxy_lib,
                               str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(2)]
    logs = [p.communicate(timeout=4 * TIMEOUT_S)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log}"
    res = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    payload = lambda plan: sum(n * pieces for _, _, n, _, pieces in plan)
    want = sum(payload(_chunks(e)) for e in range(1, EPOCHS + 1))
    for r in res:
        assert r["clean"] and r["checked"] == want and r["acks"] == [EPOCHS, EPOCHS], r
        sent = r["counters"]["send"]
        # every chunk and byte sent, in fewer messages than chunks where runs formed
        # acknowledgements: the last one up when the proxy looks (it may skip one)
        assert sent["chunks"] == r["chunks"] and sent["bytes"] == want and 1 <= sent["acks"] <= EPOCHS, sent
        assert 1 <= sent["messages"] <= sent["chunks"] and sent["syscalls"] >= sent["messages"] + sent["acks"], sent
    for r, other in ((res[0], res[1]), (res[1], res[0])):
        got = r["counters"]["recv"]
        assert got["chunks"] == other["chunks"] and got["bytes"] == want, got
    assert res[0]["abort"] == 1 and res[0]["failed"] == 1 and "closed" in res[0]["why"], res[0]


# ---- runs, in one process over a socket pair ------------------------------------------------

_HEADER = struct.Struct("<8I5Q")  # peer_proxy.cpp's Header


def _pair(lib, cap: int):
    """Two proxies of one process joined by a socket pair, each with its
    link's words and a staging of ``cap`` bytes a slot."""
    a, b = socket.socketpair()
    sides = []
    for sock in (a, b):
        w = _Words(lib)
        proxy = w.start(lib, sock.detach(), cap)
        sides.append((w, proxy, w.stage))
    return sides


@pytest.mark.parametrize("kind", ["gather", "sum"])
def test_proxy_sends_a_run_as_one_message(proxy_lib, kind):
    """A run of raised chunks crosses as one message. A gather's m = 40
    chunks a step apart (the last short) and a sum's first phase (3
    strided pieces a chunk, the last chunk short, then an empty one) and
    second phase (from flag ``HALF`` on), raised with the half's first flag
    last so that the sender sees each half's chunks up at once: every byte
    lands at its offset, every flag is raised to the epoch, and the
    counters show one message a half of the chunks and bytes, one send
    call each, and what the peer's receiver counted."""
    lib = _load_proxy(proxy_lib)
    cap = 1 << 20
    (w, proxy, st), (w2, proxy2, st2) = _pair(lib, cap)
    C, S, e, slot = 4096, 200_000, 3, 1
    if kind == "gather":
        halves = [[(k, k * C, C if k < 39 else 1000, 0, 1) for k in range(40)]]
    else:
        first = [(k, k * C, C, S, 3) for k in range(11)] + [(11, 11 * C, 700, S, 3), (12, 12 * C, 0, S, 3)]
        halves = [first, [(HALF + k, 3 * S + k * C, C, 0, 1) for k in range(6)]]
    plan = [c for half in halves for c in half]
    for k, off, n, stride, pieces in plan:
        for j in range(pieces):
            at = slot * cap + off + j * stride
            st[0][at:at + n] = _bytes(0, e, k, j, n)
        w.out_desc[slot, k] = (off, n, stride, pieces)
    for half in halves:
        for k, *_ in half[1:] + half[:1]:  # the half's first flag last
            w.out_flags[slot, k] = e
    try:
        for k, off, n, stride, pieces in plan:
            _wait(lambda: w2.in_flags[slot, k] == e, f"chunk {k}")
            for j in range(pieces):
                at = slot * cap + off + j * stride
                assert np.array_equal(st2[1][at:at + n], _bytes(0, e, k, j, n)), (k, j)
        nbytes = sum(n * pieces for _, _, n, _, pieces in plan)
        sent, got = _counters(lib, proxy)["send"], _counters(lib, proxy2)["recv"]
        assert sent["messages"] == len(halves) and sent["chunks"] == len(plan) and sent["bytes"] == nbytes, sent
        assert sent["syscalls"] == len(halves), sent  # a header and its pieces: one sendmsg
        assert got["messages"] == len(halves) and got["chunks"] == len(plan) and got["bytes"] == nbytes, got
        assert int(w.abort[0]) == 0 and int(w2.abort[0]) == 0
    finally:
        lib.loam_proxy_stop(proxy)
        lib.loam_proxy_stop(proxy2)


def test_proxy_raises_the_abort_word_on_a_peer_lost_in_a_run(proxy_lib):
    """A peer that sends a run's header and part of its bytes, then
    closes its socket: the receiving proxy raises the abort word and names
    the closed socket, and no flag of the run is raised."""
    lib = _load_proxy(proxy_lib)
    w = _Words(lib)
    mine, theirs = socket.socketpair()
    proxy = w.start(lib, mine.detach(), 1 << 20)
    try:
        # a run of 8 chunks of 64 KB of epoch 1 into slot 1, a third of its bytes sent
        theirs.sendall(_HEADER.pack(0x4C4F414D, 1, 1, 0, 8, 1, 0, 0, 1, 0, 64 << 10, 8 * (64 << 10), 0))
        theirs.sendall(bytes(170_000))
        theirs.close()
        _wait(lambda: w.abort[0] == 1, "the abort word")
        msg = ctypes.create_string_buffer(256)
        assert lib.loam_proxy_failed(proxy, msg, 256) == 1 and "closed" in msg.value.decode(), msg.value
        assert not w.in_flags.any()
        assert _counters(lib, proxy)["recv"]["messages"] == 0
    finally:
        lib.loam_proxy_stop(proxy)


@pytest.mark.parametrize("links", [20])
def test_proxy_over_many_links(proxy_lib, links):
    """Two proxies of one process joined by 20 socket pairs, past the
    kernel's old cap of 16 ranks (a rank of 24 on 3 hosts of 8 has 16 remote
    peers): every link of each side carries a gather's epoch of 6 chunks of
    its own bytes into the other's staging and an acknowledgement; every
    byte lands at its offset, every flag and acknowledgement is up, and each
    link's counters show every chunk, byte and acknowledgement sent and
    received."""
    lib = _load_proxy(proxy_lib)
    cap, C, K, e, slot = 64 << 10, 5000, 6, 1, 1
    pairs = [socket.socketpair() for _ in range(links)]
    sides = []
    try:
        for end in range(2):
            words = [_Words(lib) for _ in range(links)]
            abort = np.zeros(1, dtype=np.uint64)
            stages = [(np.zeros(2 * cap, dtype=np.uint8), np.zeros(2 * cap, dtype=np.uint8)) for _ in range(links)]
            each = lambda xs: (ctypes.c_void_p * links)(*(x.ctypes.data for x in xs))
            proxy = lib.loam_proxy_start(links, (ctypes.c_int * links)(*(p[end].detach() for p in pairs)),
                                         each(w.link for w in words), each(st[0] for st in stages),
                                         each(st[1] for st in stages), cap, abort.ctypes.data)
            sides.append((words, proxy, stages, abort))
        for end, (words, _, stages, _) in enumerate(sides):
            for i, (w, st) in enumerate(zip(words, stages)):
                for k in range(K):
                    st[0][slot * cap + k * C:slot * cap + (k + 1) * C] = _bytes(100 * end + i, e, k, 0, C)
                    w.out_desc[slot, k] = (k * C, C, 0, 1)
                for k in range(K):
                    w.out_flags[slot, k] = e
                w.acks[0] = e  # ack_out
        for end, (words, proxy, stages, abort) in enumerate(sides):
            other = 1 - end
            for i, (w, st) in enumerate(zip(words, stages)):
                for k in range(K):
                    _wait(lambda: w.in_flags[slot, k] == e, f"side {end} link {i} chunk {k}")
                    got = st[1][slot * cap + k * C:slot * cap + (k + 1) * C]
                    assert np.array_equal(got, _bytes(100 * other + i, e, k, 0, C)), (end, i, k)
                _wait(lambda: w.acks[1] == e, f"side {end} link {i}'s acknowledgement")
            raw = (ctypes.c_ulonglong * 16)()
            names = ("messages", "chunks", "bytes", "acks")
            for i in range(links):
                # the receiver counts a run after its flags
                _wait(lambda: lib.loam_proxy_counters(proxy, i, raw) == 8 and raw[9] == K, "the receiver's count")
                sent, got = dict(zip(names, raw[:4])), dict(zip(names, raw[8:12]))
                assert sent["chunks"] == K and sent["bytes"] == K * C and 1 <= sent["messages"] <= K, (end, i, sent)
                assert sent["acks"] == 1 and got["chunks"] == K and got["bytes"] == K * C and got["acks"] == 1, \
                    (end, i, got)
            assert int(abort[0]) == 0
    finally:
        for _, proxy, _, _ in sides:
            lib.loam_proxy_stop(proxy)


# ---- 4 gloo ranks on 2 hosts ---------------------------------------------------------------


def test_four_gloo_ranks_on_two_hosts_equal_one_rank(tmp_path):
    """``make_mesh(hosts=[0, 0, 1, 1])`` on 4 gloo ranks (the harness of
    ``test_torch_multiprocess.py``): islands ((0, 1), (2, 3)) on every
    rank, and six ``scan_to_map_step_sharded`` frames bit-equal to every
    other rank and to 1 rank x 4 shards."""
    from test_torch_multiprocess import _bit_equal_to_one_rank

    ranks = _bit_equal_to_one_rank("scan_to_map", tmp_path, world=4, hosts="0,0,1,1")
    for res in ranks:
        assert res["islands"].tolist() == [0, 0, 1, 1]


if __name__ == "__main__":
    if sys.argv[1] == "proxy":
        _proxy_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
