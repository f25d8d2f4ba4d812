"""The mesh across hosts, on the CPU: the host grouping, the host proxy of
the cross-host leg, and a gloo mesh labelled as two hosts.

  * ``peer_cuda.islands``: the islands a mesh's host labels and its cards'
    reach give, asking the reach only of ranks with one label (identical
    servers share PCI bus ids: cards of two machines are never compared),
    and ``check_hosts``'s refusals.
  * ``csrc/peer_proxy.cpp`` built with ``g++`` and driven in two processes
    over loopback TCP (this file as the worker,
    ``python tests/test_torch_cross_host.py proxy <rank> <port> <lib> <out>``):
    each process stands in for a rank's kernel, writing chunks into its out
    staging, their descriptions and flags into the words of
    ``csrc/peer_link.h`` as the kernel does (the bytes, then the
    description, then the flag), over 7 epochs on two mailbox generations
    (each slot rewritten after the peer's acknowledgement of the epoch
    before last), flags raised in a shuffled order and chunks of one piece,
    of several pieces a stride apart (a sum's first phase) and empty; every
    byte the peer's proxy lands, every flag and every acknowledgement is
    checked; then one process leaves without stopping its proxy, and the
    other's proxy must raise the abort word and name the closed socket.
  * 4 gloo ranks of ``tests/test_torch_multiprocess.py``'s harness with
    ``make_mesh(hosts=[0, 0, 1, 1])``: its islands, and
    ``scan_to_map_step_sharded`` bit-equal to 1 rank x 4 shards.
"""

import ctypes
import json
import os
import random
import socket
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

# a chunk: (flag index, offset, bytes a piece, stride, pieces); the second
# generation's regions are larger and take one chunk more
_PLAN = [(0, 0, 1000, 0, 1), (1, 1008, 0, 0, 1), (2, 2048, 512, 4096, 3), (3, 12000, 20000, 0, 1),
         (CHUNKS // 2 + 1, 40000, 3000, 0, 1)]
_GENS = ((1, 64 << 10), (4, 256 << 10))  # (first epoch, bytes a region)
_BIG = (7, 70000, 150000, 0, 1)


def _generation(e: int):
    g = max(i for i, (first, _) in enumerate(_GENS) if e >= first)
    return g, _GENS[g][1]


def _chunks(e: int) -> list:
    return _PLAN + ([_BIG] if _generation(e)[0] else [])


def _bytes(rank: int, e: int, k: int, j: int, n: int) -> np.ndarray:
    return ((rank * 131 + e * 31 + k * 7 + j * 3 + np.arange(n)) % 251).astype(np.uint8)


def _wait(cond, what: str) -> None:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > TIMEOUT_S:
            raise TimeoutError(what)
        time.sleep(1e-4)


def _proxy_worker(rank: int, port: int, lib_path: str, out: str) -> None:
    """One side of the proxy test (the module docstring)."""
    lib = ctypes.CDLL(lib_path)
    lib.loam_proxy_start.restype = ctypes.c_void_p
    lib.loam_proxy_start.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.c_void_p]
    lib.loam_proxy_stage.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_ulonglong]
    lib.loam_proxy_failed.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.loam_proxy_stop.argtypes = [ctypes.c_void_p]
    words = lib.loam_proxy_link_bytes() // 8
    assert words == 2 * CHUNKS * 6 + 2, words  # out flags, descriptions (4 words), in flags; two acks
    link = np.zeros(words, dtype=np.uint64)
    out_flags = link[:2 * CHUNKS].reshape(2, CHUNKS)
    out_desc = link[2 * CHUNKS:10 * CHUNKS].reshape(2, CHUNKS, 4)
    in_flags = link[10 * CHUNKS:12 * CHUNKS].reshape(2, CHUNKS)
    acks = link[12 * CHUNKS:]  # ack_out, ack_in
    abort = np.zeros(1, dtype=np.uint64)
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
    fds = (ctypes.c_int * 1)(sock.detach())
    proxy = lib.loam_proxy_start(1, fds, (ctypes.c_void_p * 1)(link.ctypes.data), abort.ctypes.data)
    stages = []
    for g, (_, cap) in enumerate(_GENS):
        st = (np.zeros(2 * cap, dtype=np.uint8), np.zeros(2 * cap, dtype=np.uint8))
        stages.append(st)
        assert lib.loam_proxy_stage(proxy, g, 0, st[0].ctypes.data, st[1].ctypes.data, cap) == 0
    rng = random.Random(rank)
    peer, checked = 1 - rank, 0
    for e in range(1, EPOCHS + 1):
        g, cap = _generation(e)
        slot = e & 1
        if e > 2:  # the credit: the peer read this slot at e - 2
            _wait(lambda: acks[1] >= e - 2, f"the peer's acknowledgement of epoch {e - 2}")
        plan = _chunks(e)
        for k, off, n, stride, pieces in rng.sample(plan, len(plan)):
            for j in range(pieces):
                at = slot * cap + off + j * stride
                stages[g][0][at:at + n] = _bytes(rank, e, k, j, n)
            out_desc[slot, k] = (off, n, stride, (g << 32) | pieces)
            out_flags[slot, k] = e  # after the bytes and the description
        for k, off, n, stride, pieces in plan:
            _wait(lambda: in_flags[slot, k] >= e, f"the peer's chunk {k} of epoch {e}")
            assert in_flags[slot, k] == e
            for j in range(pieces):
                at = slot * cap + off + j * stride
                got = stages[g][1][at:at + n]
                assert np.array_equal(got, _bytes(peer, e, k, j, n)), (e, k, j)
                checked += n
        acks[0] = e
    _wait(lambda: acks[1] >= EPOCHS, "the peer's last acknowledgement")
    msg = ctypes.create_string_buffer(256)
    clean = int(abort[0]) == 0 and lib.loam_proxy_failed(proxy, msg, 256) == 0
    result = {"checked": checked, "clean": clean, "acks": [int(a) for a in acks]}
    if rank == 1:
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
        time.sleep(0.5)  # its proxy sends the last acknowledgement on
        os._exit(0)  # leaves with its proxy running: the socket closes under it
    _wait(lambda: abort[0] == 1, "the abort word after the peer left")
    failed = lib.loam_proxy_failed(proxy, msg, 256)
    result.update(abort=int(abort[0]), failed=failed, why=msg.value.decode())
    lib.loam_proxy_stop(proxy)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_proxy_moves_every_chunk_and_ack_and_raises_on_a_lost_peer(tmp_path):
    lib = tmp_path / "peer_proxy.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-fPIC", "-shared", "-pthread", "-o", str(lib),
                    os.path.join(_CSRC, "peer_proxy.cpp")], check=True)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(_HERE) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "proxy", str(r), str(port), str(lib),
                               str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(2)]
    logs = [p.communicate(timeout=4 * TIMEOUT_S)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log}"
    res = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    per_epoch = sum(n * pieces for _, _, n, _, pieces in _PLAN)
    want = EPOCHS * per_epoch + sum(_BIG[2] for e in range(1, EPOCHS + 1) if _generation(e)[0])
    for r in res:
        assert r["clean"] and r["checked"] == want and r["acks"] == [EPOCHS, EPOCHS], r
    assert res[0]["abort"] == 1 and res[0]["failed"] == 1 and "closed" in res[0]["why"], res[0]


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
