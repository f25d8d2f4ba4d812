"""The mesh's collectives over peer memory: a gather of a list of tensors
(every rank's block of each, concatenated in rank order) and a sum of every
shard's block in global shard order, one kernel launch each.

:func:`peer_gather` and :func:`peer_sum` launch ``csrc/peer_gather.cu`` for
CUDA tensors. For CPU tensors they run the plain versions over the mesh's
group (gloo): the gather packs the leaves into one byte buffer at the
kernel's offsets (:func:`layout`) and gathers it with one
``dist.all_gather_into_tensor``, which equals :func:`peer_gather_reference`,
the leaves gathered one by one, bit for bit; :func:`peer_sum_reference`
gathers the blocks and adds them one after another in global shard order.
The kernel's gather copies bytes and its sum makes the same IEEE adds in the
same order, so both equal the plain versions bit for bit.

It replaces no Pallas kernel: ``loam_tpu`` leaves its collectives to XLA,
inside its jitted loops (the sharded kNN's gather in the ICF
``lax.while_loop``, the insert's ``psum`` under ``lax.cond``, the pose
graph's ``psum`` of H, b and the cost in its LM loop). NCCL refuses a
collective captured inside a CUDA-graph WHILE or IF body past one rank; the
kernel reads nothing from the host and takes its epoch from device memory,
so a graph captures it anywhere, and a sharded program is one graph at every
world size.

The sum is a reduce-scatter and an all-gather in one launch: rank q adds up
slice q of the block (:func:`sum_slice` bytes) over every shard in global
order and sends the sums to every peer, so each element's adds keep their
order and each peer receives (L + 1) slices, not L blocks.

A :class:`PeerMailbox` holds a mesh's buffers on this rank (``make_mesh``
makes it, every rank at once; ``Mesh.release`` frees it): a mailbox of two
slots of one region a rank, the control words (a flag a sender and chunk,
an acknowledgement a rank, the epoch), made with ``cudaMalloc``, the peers'
opened through CUDA IPC. Every pair of the mesh's cards must reach each
other's memory (``cudaDeviceCanAccessPeer``): the setup raises, naming the
pair, where two cannot. Where a payload outgrows the mailbox's region
outside a capture, every rank makes a larger mailbox there in a collective
exchange of the new handles (every rank reaches the same collective with
the same shapes; a program's eager warm-up runs every collective before its
capture); the earlier mailboxes stay mapped until the release, since graphs
captured on them replay them. A payload larger than the region inside a
capture raises. At one rank the gather is one copy kernel, the sum one
kernel that reads the L blocks and writes one, and neither needs a mailbox.
A rank that waits for another past :data:`WAIT_SECONDS` traps in the
kernel, and the call raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from ..program import Counted
from . import _build

#: A rank's longest wait for another inside one collective before the
#: kernel traps. A trap ends the process's CUDA context, so the wait outlasts
#: by far how far the ranks drift apart between two collectives (one rank
#: capturing a program while another replays it, host work between two
#: calls); NCCL's watchdog in PyTorch waits 10 minutes.
WAIT_SECONDS = 60.0
#: The first mailbox's region (a rank's payload) in bytes; a larger
#: mailbox's region is a multiple of :data:`GROW_BYTES`, and at least twice
#: the last (a mesh keeps them all). A mailbox holds 2 x world regions.
FIRST_SLOT_BYTES = 1 << 20
GROW_BYTES = 2 << 20
#: Where each leaf of a gather starts in the packed payload: a multiple of
#: this many bytes, so every leaf's block takes the kernel's 16-byte path.
ALIGN = 16
#: The dtypes the sum takes, as the kernel names them.
SUM_DTYPES = {torch.float32: 0, torch.float64: 1, torch.int32: 2, torch.int64: 3}

_HANDLE = 64  # sizeof(cudaIpcMemHandle_t)
_BUS = 16  # a PCI bus id, "0000:00:00.0" and its NUL
_GATHER, _SUM = 0, 1


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"peer gather: {what} failed with cudaError_t {err}")


def layout(nbytes) -> tuple:
    """Each leaf's offset in a rank's packed payload (a multiple of
    :data:`ALIGN`, in order) and the payload's bytes."""
    offsets, at = [], 0
    for n in nbytes:
        offsets.append(at)
        at += -(-n // ALIGN) * ALIGN
    return offsets, at


def sum_slice(block: int, world: int) -> int:
    """The bytes of a block that each rank adds up in a sum (the kernel's
    reduce-scatter): the block over the ranks, rounded up to 16."""
    return -(-(-(-block // world)) // ALIGN) * ALIGN


def _exchange(group, dev: torch.device, mine: bytes) -> list:
    """Every rank's ``mine`` (the same length on each), in rank order: one
    eager ``all_gather_into_tensor`` over ``group``, on the current stream,
    through the card where the group is NCCL's."""
    world = dist.get_world_size(group)
    on = dev if "nccl" in str(dist.get_backend(group)) else torch.device("cpu")
    x = torch.frombuffer(bytearray(mine), dtype=torch.uint8).to(on)
    every = torch.empty(world * len(mine), dtype=torch.uint8, device=on)
    dist.all_gather_into_tensor(every, x, group=group)
    flat = bytes(every.cpu().numpy())
    return [flat[r * len(mine):(r + 1) * len(mine)] for r in range(world)]


def _gathered(x: torch.Tensor, world: int, dev=None) -> torch.Tensor:
    """An empty output of the gather of ``x``: (world * its leading axis, ...)."""
    if x.ndim == 0:
        raise ValueError("a gathered tensor needs a leading axis")
    return torch.empty((world * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=dev or x.device)


class PeerMailbox:
    """This rank's buffers of a mesh's collectives on ``dev``, the peers'
    mapped (module docstring). Made by every rank of ``group`` at once."""

    def __init__(self, group, dev: torch.device):
        self.group, self.dev = group, dev
        self.world, self.rank = dist.get_world_size(group), dist.get_rank(group)
        lib = _build.lib()
        if self.world > lib.loam_peer_max_ranks():
            raise ValueError(f"the peer gather takes at most {lib.loam_peer_max_ranks()} ranks, the group "
                             f"has {self.world}")
        handle = ctypes.c_void_p()
        with torch.cuda.device(dev):
            _check(lib.loam_peer_create(self.world, self.rank, WAIT_SECONDS, ctypes.byref(handle)), "creating")
        self.handle, self.cap, self.buses = handle.value, 0, [b"?"] * self.world
        try:
            self._setup(lib)
        except BaseException:
            with torch.cuda.device(dev):
                lib.loam_peer_close(self.handle)
                lib.loam_peer_free(self.handle)
            self.handle = None
            raise

    def _setup(self, lib) -> None:
        if self.world == 1:
            return
        bus, ctl = ctypes.create_string_buffer(_BUS), ctypes.create_string_buffer(_HANDLE)
        with torch.cuda.device(self.dev):
            _check(lib.loam_peer_bus_id(bus, _BUS), "reading the card's PCI bus id")
            _check(lib.loam_peer_flags_handle(self.handle, ctl), "cudaIpcGetMemHandle of the control words")
        box = self._new_mailbox(lib, FIRST_SLOT_BYTES)
        every = _exchange(self.group, self.dev, bus.raw + ctl.raw + box)
        self.buses = buses = [e[:_BUS] for e in every]
        with torch.cuda.device(self.dev):
            for a in range(self.world):
                for b in range(a + 1, self.world):
                    ok = ctypes.c_int()
                    _check(lib.loam_peer_can_reach(buses[a], buses[b], ctypes.byref(ok)),
                           "cudaDeviceCanAccessPeer")
                    if ok.value == 0:
                        raise RuntimeError(
                            f"the mesh's cards {_name(buses[a])} (rank {a}) and {_name(buses[b])} (rank {b}) "
                            f"cannot reach each other's memory (cudaDeviceCanAccessPeer): the mesh's gather "
                            f"needs every pair of its cards peer-reachable")
        self._open(lib, b"".join(e[_BUS:] for e in every))

    def _new_mailbox(self, lib, cap: int) -> bytes:
        box = ctypes.create_string_buffer(_HANDLE)
        with torch.cuda.device(self.dev):
            _check(lib.loam_peer_mailbox(self.handle, cap, box), f"a mailbox of 2 x {self.world} x {cap} bytes")
        self.cap = cap
        return box.raw

    def _open(self, lib, handles: bytes) -> None:
        failed = ctypes.c_int()
        with torch.cuda.device(self.dev):
            err = lib.loam_peer_open(self.handle, handles, ctypes.byref(failed))
        if err != 0:
            r, buses = failed.value, self.buses
            raise RuntimeError(f"peer gather: rank {self.rank} ({_name(buses[self.rank])}) could not map rank "
                               f"{r}'s buffers ({_name(buses[r]) if r >= 0 else '?'}) with "
                               f"cudaIpcOpenMemHandle: cudaError_t {err}; the mesh's gather needs every pair "
                               f"of its cards peer-reachable")

    def reserve(self, nbytes: int) -> None:
        """A mailbox region of at least ``nbytes`` past one rank: a larger
        mailbox (every rank at once, outside a capture) where it is
        smaller."""
        if self.world == 1 or nbytes <= self.cap:
            return
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"peer gather: {nbytes} bytes a rank inside a capture, past the mailbox's "
                               f"{self.cap}: the mailbox grows only outside a capture (a program's warm-up "
                               f"runs every gather first)")
        lib = _build.lib()
        box = self._new_mailbox(lib, max(-(-nbytes // GROW_BYTES) * GROW_BYTES, 2 * self.cap))
        every = _exchange(self.group, self.dev, box)
        self._open(lib, b"".join(b"\0" * _HANDLE + e for e in every))

    def _run(self, what: str, t: torch.Tensor, segments: list, mode: int, dtype: int, total: int, L: int) -> None:
        if self.handle is None:
            raise RuntimeError("peer gather: the mesh was released")
        lib = _build.lib()
        if len(segments) > lib.loam_peer_max_segments():
            raise ValueError(f"peer gather: {len(segments)} leaves in one gather, at most "
                             f"{lib.loam_peer_max_segments()}")
        self.reserve(total if mode == _GATHER else (L + 1) * sum_slice(total, self.world))
        flat = (ctypes.c_longlong * (4 * len(segments)))(*(v for seg in segments for v in seg))
        _build.launch(lib.loam_peer_run, what, t, self.handle, flat, len(segments), mode, dtype, total, L)

    def gather(self, leaves: list) -> list:
        """The kernel's gather of the contiguous CUDA tensors ``leaves``
        (each with a leading axis of the same length on every rank) in one
        launch: each leaf's blocks in rank order."""
        for x in leaves:
            _build.require(x, "x", (x.dtype,), device=self.dev)
        outs = [_gathered(x, self.world) for x in leaves]
        sizes = [x.numel() * x.element_size() for x in leaves]
        offsets, total = layout(sizes)
        self._run("peer_gather", leaves[0], [(x.data_ptr(), o.data_ptr(), at, n) for x, o, at, n in
                                             zip(leaves, outs, offsets, sizes)], _GATHER, 0, total, 1)
        return outs

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The kernel's sum of the contiguous CUDA tensor ``x`` (L, ...),
        every shard's block in global shard order: (...)."""
        _build.require(x, "x", tuple(SUM_DTYPES), device=self.dev)
        if x.ndim == 0 or x.shape[0] == 0:
            raise ValueError(f"a summed tensor needs a leading axis of shards, got shape {tuple(x.shape)}")
        out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
        block = out.numel() * out.element_size()
        self._run("peer_sum", x, [(x.data_ptr(), out.data_ptr(), 0, x.shape[0] * block)], _SUM,
                  SUM_DTYPES[x.dtype], block, x.shape[0])
        return out

    def release(self, wait: bool = True) -> None:
        """Unmap the peers' buffers, wait for every rank to have unmapped
        this rank's (every rank calls it, while the group lives; ``wait``
        False skips that, for a group already destroyed), and free them."""
        if self.handle is None:
            return
        lib = _build.lib()
        torch.cuda.synchronize(self.dev)
        with torch.cuda.device(self.dev):
            _check(lib.loam_peer_close(self.handle), "closing the peers' buffers")
        if self.world > 1 and wait:
            _exchange(self.group, self.dev, b"\0")
        with torch.cuda.device(self.dev):
            err = lib.loam_peer_free(self.handle)
        self.handle = None
        _check(err, "freeing the buffers")


def _name(bus: bytes) -> str:
    return bus.split(b"\0", 1)[0].decode() or "?"


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a collective takes it: contiguous, bool as uint8 (not every
    backend gathers bool)."""
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


def _one_reference(x: torch.Tensor, group) -> torch.Tensor:
    wire = _wire(x)
    out = _gathered(wire, dist.get_world_size(group))
    dist.all_gather_into_tensor(out, wire, group=group)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def peer_gather_reference(x, group):
    """Plain version: ``dist.all_gather_into_tensor`` over ``group``, a
    leaf at a time (``x`` a tensor, or a list of them)."""
    if isinstance(x, torch.Tensor):
        return _one_reference(x, group)
    return [_one_reference(t, group) for t in x]


def _gather_packed(leaves: list, group) -> list:
    """The leaves packed into one byte buffer at :func:`layout`'s offsets,
    gathered with one ``all_gather_into_tensor`` and unpacked: the kernel's
    layout, over the group's backend."""
    world = dist.get_world_size(group)
    wires = [_wire(x) for x in leaves]
    sizes = [x.numel() * x.element_size() for x in wires]
    offsets, total = layout(sizes)
    packed = torch.zeros(total, dtype=torch.uint8, device=wires[0].device)
    for x, at, n in zip(wires, offsets, sizes):
        packed[at:at + n] = x.reshape(-1).view(torch.uint8)
    every = torch.empty(world * total, dtype=torch.uint8, device=packed.device)
    dist.all_gather_into_tensor(every, packed, group=group)
    every = every.view(world, total)
    outs = []
    for x, wire, at, n in zip(leaves, wires, offsets, sizes):
        blocks = every[:, at:at + n].contiguous().view(wire.dtype)
        out = blocks.reshape((world * wire.shape[0],) + tuple(wire.shape[1:]))
        outs.append(out.to(torch.bool) if x.dtype == torch.bool else out)
    return outs


def peer_gather(x, mailbox, group):
    """Every rank's ``x`` (a tensor, or a list of them, each with a leading
    axis of the same length on every rank) concatenated along that axis in
    rank order, all in one collective: the kernel through ``mailbox`` (the
    mesh's :class:`PeerMailbox`) for CUDA tensors, the packed plain gather
    over ``group`` for CPU ones."""
    leaves = [x] if isinstance(x, torch.Tensor) else list(x)
    if not leaves:
        return []
    if any(t.ndim == 0 for t in leaves):
        raise ValueError("a gathered tensor needs a leading axis")
    if not leaves[0].is_cuda:
        outs = _gather_packed(leaves, group)
    else:
        if mailbox is None:
            raise ValueError("a CUDA tensor gathered on a mesh without a peer mailbox: make the mesh on its card "
                             "with make_mesh")
        outs = mailbox.gather([t.contiguous() for t in leaves])
        peer_gather.counter.add()
    return outs[0] if isinstance(x, torch.Tensor) else outs


def peer_sum_reference(x: torch.Tensor, group) -> torch.Tensor:
    """Plain version: every rank's blocks gathered, then added one after
    another in global shard order."""
    parts = peer_gather_reference(x, group)
    out = parts[0].clone()
    for part in parts[1:]:
        out += part
    return out


def peer_sum(x: torch.Tensor, mailbox, group) -> torch.Tensor:
    """The sum of every shard's block of the per-shard ``x`` (L, ...) over
    every rank, added one after another in global shard order: the kernel
    through ``mailbox`` for a CUDA tensor (the gathered blocks are never
    made), :func:`peer_sum_reference` over ``group`` for a CPU one."""
    if not x.is_cuda:
        return peer_sum_reference(x, group)
    if mailbox is None:
        raise ValueError("a CUDA tensor summed on a mesh without a peer mailbox: make the mesh on its card "
                         "with make_mesh")
    out = mailbox.sum(x.contiguous())
    peer_sum.counter.add()
    return out


#: Kernel launches since the last reset (plain-version calls do not count;
#: read through conditional bodies, ``program.Counted``).
peer_gather = Counted(peer_gather)
peer_sum = Counted(peer_sum)
