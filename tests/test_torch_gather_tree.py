"""The mesh's tree gather and fixed-order sum on gloo ranks, on the CPU.

``collectives.gather`` takes a tree of tensors and gathers every leaf in one
collective: on the card one kernel launch over a list of segments, here the
leaves packed at the kernel's offsets (``peer_cuda.layout``) into one byte
buffer and gathered with one ``all_gather_into_tensor``. ``collectives.sum``
adds every shard's block in global shard order. Each test starts the ranks
of a gloo group, this file as the script,

    python tests/test_torch_gather_tree.py <rank> <world> <port> <shards> <out_dir>

which gather a tree of mixed leaves (float32, float64, int32, int64, bool,
uint8, a 0-length leaf, ``None``, NamedTuples, tuples and a list) and sum
float32, float64, int32 and int64 blocks, and write what they got to
``<out_dir>/rank<r>.npz``. The tree's every leaf must equal its gather
alone (``peer_gather_reference``, ``dist.all_gather_into_tensor`` a leaf)
and every rank's blocks in rank order, bit for bit; every sum must equal,
bit for bit, numpy's adds of every shard's block one after another in
global shard order, on 2 ranks of 2 shards and on 1 rank of 4.
"""

import os
import socket
import subprocess
import sys
from typing import NamedTuple, Optional

import numpy as np
import pytest
import torch
import torch.distributed as dist

from loam_tpu_torch import parallel
from loam_tpu_torch.ops.peer_cuda import ALIGN, layout, peer_gather_reference
from loam_tpu_torch.parallel import collectives

torch.set_num_threads(1)

_HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT_S = 120
SUMS = {"f32": (np.float32, (33,)), "f64": (np.float64, (5, 4)), "i32": (np.int32, (6,)), "i64": (np.int64, ())}


class Inner(NamedTuple):
    points: torch.Tensor
    mask: torch.Tensor
    empty: torch.Tensor
    missing: Optional[torch.Tensor]


class Tree(NamedTuple):
    inner: Inner
    counts: torch.Tensor
    pair: tuple


def _tree(rank: int, shards: int) -> Tree:
    """This rank's leaves, (shards, ...) each, seeded by the rank."""
    g = np.random.default_rng(rank)
    S = shards
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return Tree(
        Inner(t(g.standard_normal((S, 7, 3)).astype(np.float32)), t(g.random((S, 13)) > 0.5),
              t(np.zeros((S, 0), np.int32)), None),
        t(g.integers(-2**62, 2**62, (S, 3))),
        (t(g.standard_normal((S, 5)).astype(np.float64)),
         [t(g.integers(-2**31, 2**31 - 1, (S, 2, 3), dtype=np.int32)), t(g.integers(0, 255, (S, 9), np.uint8))]))


def _leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for part in tree for x in _leaves(part)]


def _sums(rank: int, shards: int) -> dict:
    """This rank's per-shard blocks to sum, by name."""
    g = np.random.default_rng(100 + rank)
    out = {}
    for name, (dtype, shape) in SUMS.items():
        if np.issubdtype(dtype, np.integer):
            x = g.integers(-2**30, 2**30, (shards,) + shape).astype(dtype)
        else:  # magnitudes far apart, so the order of the adds shows in the bits
            x = (g.standard_normal((shards,) + shape) * 10.0 ** g.integers(-6, 7, (shards,) + shape)).astype(dtype)
        out[name] = x
    return out


def main(rank: int, world: int, port: int, shards: int, out_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    try:
        mesh = parallel.make_mesh(["cpu"] * shards, group=dist.group.WORLD)
        tree = _tree(rank, shards)
        got = collectives.gather(mesh, tree)
        assert type(got) is Tree and type(got.inner) is Inner and type(got.pair) is tuple
        assert type(got.pair[1]) is list and got.inner.missing is None
        for a, b in zip(_leaves(got), peer_gather_reference(_leaves(tree), mesh.group)):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        res = {f"gather{i}": x.numpy() for i, x in enumerate(_leaves(got))}
        res.update({f"sum_{n}": collectives.sum(mesh, torch.from_numpy(x)).numpy()
                    for n, x in _sums(rank, shards).items()})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()
    print(f"[rank {rank}] OK", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", params=[(2, 2), (1, 4)], ids=["2x2", "1x4"])
def ranks(request, tmp_path_factory):
    """(world, shards, every rank's results), the ranks run once a layout."""
    world, shards = request.param
    out_dir = tmp_path_factory.mktemp(f"tree{world}x{shards}")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.dirname(_HERE) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world), str(port), str(shards), str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=os.path.dirname(_HERE))
        for r in range(world)]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0 and f"[rank {r}] OK" in out, f"rank {r} failed:\n{out}"
    return world, shards, [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(world)]


def test_tree_gather_is_every_leaf_in_rank_order(ranks):
    """One gather of the tree: each leaf every rank's block in rank order
    (the ranks checked it against the leaf's own gather), the same bits on
    every rank."""
    world, shards, res = ranks
    want = [np.concatenate([x.numpy() for x in blocks])
            for blocks in zip(*(_leaves(_tree(r, shards)) for r in range(world)))]
    for r in range(world):
        got = [res[r][f"gather{i}"] for i in range(len(want))]
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), (r, i)


def test_sum_adds_in_global_shard_order(ranks):
    """Every sum bit-equal to numpy's adds of the shards' blocks one after
    another in global shard order, on every rank."""
    world, shards, res = ranks
    blocks = [_sums(r, shards) for r in range(world)]
    for name in SUMS:
        parts = [b for r in range(world) for b in blocks[r][name]]
        want = parts[0].copy()
        for part in parts[1:]:
            want = want + part
        for r in range(world):
            got = res[r][f"sum_{name}"]
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == np.asarray(want).tobytes(), (name, r)


def test_layout_packs_at_aligned_offsets():
    """Each leaf starts at a multiple of the alignment after the one before,
    empty leaves take no room, and the payload ends aligned."""
    sizes = [0, 5, 16, 17, 0, 1, 48]
    offsets, total = layout(sizes)
    assert offsets == [0, 0, 16, 32, 64, 64, 80] and total == 128
    assert all(o % ALIGN == 0 for o in offsets) and total % ALIGN == 0
    assert layout([]) == ([], 0)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
