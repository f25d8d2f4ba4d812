"""One rank of the mesh's collectives on the card across hosts, for
``tests/test_torch_cuda.py`` (no JAX: it runs on a machine without it).

    python tests/torch_cross_host_worker.py <rank> <world> <port> <hosts> <mode> <out_dir> [<window>]

The ranks join a gloo group over 127.0.0.1 (gloo, since NCCL takes one rank
a card and the ranks may share one), each on card ``rank % cards``, and make
a mesh of one shard a rank with ``hosts`` (comma-separated labels, one a
rank, or ``machine`` for each rank's machine: ranks of one card are then one
island). ``window``: the bytes of a remote peer's staging slot
(``peer_cuda.STAGE_BYTES``, set before the mesh is made), small enough for
the collectives to run in pieces. ``mode``:

  * ``check``: the kernel's tree gather and its fixed-order sum (float32,
    float64, int32, int64) eager, in a plain graph, in a WHILE body (3
    iterations) and an IF body (taken and not), each bit-equal to its plain
    version over the group (a leaf at a time through the host; the sum that
    gather then the adds in shard order); past one rank a gather past the
    mailbox raising inside a capture, growing eagerly, and the graph
    captured before replayed; a launch counted a collective that ran; the
    proxy's counters of each remote peer's link at the end.
  * ``lost``: the last rank leaves without releasing the mesh 3 s after
    the others launched a gather that waits for it; the others' call must
    raise within ``peer_cuda.WAIT_SECONDS`` (its proxy loses the socket and
    the kernel traps, or the timeout), never hang.

Each rank writes ``rank<r>.json`` into ``out_dir``.
"""

import json
import os
import sys
import time

import torch
import torch.distributed as dist

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))

from loam_tpu_torch import parallel, program  # noqa: E402
from loam_tpu_torch.ops import peer_cuda  # noqa: E402
from loam_tpu_torch.parallel import collectives  # noqa: E402


def _inputs(dev, rank):
    """A tree of leaves (float64 past the first mailbox region, odd sizes,
    int32, bool) and a sum's blocks a dtype, seeded by the rank."""
    g = torch.Generator().manual_seed(11 + rank)
    tree = [torch.randn((1, 40_001), generator=g, dtype=torch.float64),
            torch.randn((1, 3, 7), generator=g),
            torch.randint(-2**31, 2**31 - 1, (1, 5, 33), generator=g, dtype=torch.int32),
            torch.rand((1, 13), generator=g) > 0.5,
            torch.zeros((0, 4))]
    sums = [torch.randn((1, 1001), generator=g) * 10.0 ** torch.randint(-6, 7, (1, 1001), generator=g),
            torch.randn((1, 257, 3), generator=g, dtype=torch.float64),
            torch.randint(-2**31, 2**31 - 1, (1, 999), generator=g, dtype=torch.int32),
            torch.randint(-2**62, 2**62, (1, 64), generator=g, dtype=torch.int64)]
    return tuple(x.to(dev) for x in tree), tuple(x.to(dev) for x in sums)  # tuples: a program's inputs


def _equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.cpu(), b.cpu())


def _check(mesh, dev, rank) -> dict:
    tree, sums = _inputs(dev, rank)
    want_tree = peer_cuda.peer_gather_reference(list(tree), mesh.group)
    want_sums = [peer_cuda.peer_sum_reference(x, mesh.group) for x in sums]
    got = {}
    peer_cuda.peer_gather.launches = peer_cuda.peer_sum.launches = 0
    outs = collectives.gather(mesh, list(tree))
    totals = [collectives.sum(mesh, x) for x in sums]
    torch.cuda.synchronize()
    got["eager"] = (all(_equal(a, b) for a, b in zip(outs, want_tree)) and
                    all(_equal(a, b) for a, b in zip(totals, want_sums)))
    got["eager_launches"] = [peer_cuda.peer_gather.launches, peer_cuda.peer_sum.launches]

    def fn(bufs, kind):
        xs, ys, n = bufs
        outs = [torch.zeros_like(w) for w in want_tree]
        totals = [torch.zeros_like(w) for w in want_sums]

        def record():
            for o, g in zip(outs, collectives.gather(mesh, list(xs))):
                o.copy_(g)
            for o, x in zip(totals, ys):
                o.copy_(collectives.sum(mesh, x))

        if kind == "while":
            i = torch.zeros((), dtype=torch.int64, device=dev)
            going = i < n

            def body():
                record()
                i.add_(1)
                going.copy_(i < n)

            program.while_loop(going, body)
        elif kind == "plain":
            record()
        else:
            program.when(n > 2, record)
        return tuple(outs), tuple(totals)

    for kind, k in (("while", 3), ("if", 3), ("if", 2), ("plain", 1)):
        n = torch.full((), k, dtype=torch.int64, device=dev)
        prog = program.Program(dev, (tree, sums, n))
        prog.run(lambda b: fn(b, kind), (tree, sums, n))  # the capture
        peer_cuda.peer_gather.launches = peer_cuda.peer_sum.launches = 0
        outs, totals = program.clone(prog.run(lambda b: fn(b, kind), (tree, sums, n)))
        torch.cuda.synchronize()
        ran = {"while": k, "if": int(k > 2), "plain": 1}[kind]
        name = f"{kind}{k}"
        got[f"{name}_graph"] = prog.graph is not None
        got[f"{name}_launches"] = [peer_cuda.peer_gather.launches, peer_cuda.peer_sum.launches]
        got[f"{name}_want_launches"] = [ran, ran * len(sums)]
        if ran:
            got[name] = (all(_equal(a, b) for a, b in zip(outs, want_tree)) and
                         all(_equal(a, b) for a, b in zip(totals, want_sums)))
        else:
            got[name] = not any(o.any() for o in outs + totals)
        if kind == "plain" and mesh.peer is not None and dist.get_world_size(mesh.group) > 1:
            big = torch.randn((1, mesh.peer.cap // 4 + 1), generator=torch.Generator().manual_seed(rank)).to(dev)
            try:
                with torch.cuda.graph(torch.cuda.CUDAGraph()):
                    collectives.gather(mesh, big)
                got["capture_past_mailbox"] = "no error"
            except RuntimeError as err:
                got["capture_past_mailbox"] = "inside a capture" in str(err)
            got["grown"] = _equal(collectives.gather(mesh, big), peer_cuda.peer_gather_reference(big, mesh.group))
            outs, totals = program.clone(prog.run(lambda b: fn(b, kind), (tree, sums, n)))
            torch.cuda.synchronize()
            got["replay_after_growth"] = (all(_equal(a, b) for a, b in zip(outs, want_tree)) and
                                          all(_equal(a, b) for a, b in zip(totals, want_sums)))
    if mesh.peer is not None and mesh.peer.remote:  # how many pieces the largest leaf's gather took
        got["pieces"] = mesh.peer.plan(0, tree[0].numel() * tree[0].element_size())["pieces"]
        got["bytes"] = mesh.peer.footprint()
        got["wait_share"] = mesh.peer.max_wait()["share"]
    got["islands"] = [list(i) for i in mesh.islands]
    got["remote"] = list(mesh.peer.remote) if mesh.peer is not None else []
    links = mesh.peer.link_counters() if mesh.peer is not None else {}
    got["links"] = {str(t): c for t, c in links.items()}
    return got


def _lost(mesh, dev, rank, world) -> dict:
    x = torch.full((1, 1 << 16), float(rank), device=dev)
    collectives.gather(mesh, x)  # every rank once: the mesh works
    torch.cuda.synchronize()
    dist.barrier(mesh.group)
    if rank == world - 1:
        time.sleep(3.0)
        os._exit(0)  # leaves without releasing: its sockets close
    t0 = time.perf_counter()
    try:
        collectives.gather(mesh, x)
        torch.cuda.synchronize()
        return {"raised": False, "seconds": time.perf_counter() - t0}
    except RuntimeError as err:
        return {"raised": True, "seconds": time.perf_counter() - t0, "error": str(err)[:300]}


def main(rank, world, port, hosts, mode, out_dir, window=None) -> None:
    if window and int(window):
        peer_cuda.STAGE_BYTES = int(window)
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    labels = None if hosts == "machine" else hosts.split(",")
    mesh = parallel.make_mesh([dev], group=dist.group.WORLD, hosts=labels)
    res = _check(mesh, dev, rank) if mode == "check" else _lost(mesh, dev, rank, world)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    if mode == "lost":
        os._exit(0)  # the card's context is gone after a trap: no release, no teardown
    mesh.release()
    dist.destroy_process_group()
    print(f"[rank {rank}] OK", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6], *sys.argv[7:])
