"""The mesh's gather: every rank's ``x`` concatenated in rank order.

:func:`peer_gather` launches ``csrc/peer_gather.cu`` for a CUDA tensor and
runs :func:`peer_gather_reference`, ``dist.all_gather_into_tensor`` over the
mesh's group (gloo), for a CPU tensor. The kernel copies bytes, so its output
equals the reference's bit for bit.

It replaces no Pallas kernel: ``loam_tpu`` leaves its collectives to XLA,
inside its jitted loops (the sharded kNN's gather in the ICF
``lax.while_loop``, the insert's ``psum`` under ``lax.cond``, the pose
graph's ``psum`` of H, b and the cost in its LM loop). NCCL refuses a
collective captured inside a CUDA-graph WHILE or IF body past one rank;
these kernels read nothing from the host and take their epoch from device
memory, so a graph captures them anywhere, and a sharded program is one
graph at every world size.

A :class:`PeerMailbox` holds a mesh's buffers on this rank (``make_mesh``
makes it, every rank at once; ``Mesh.release`` frees it): two mailbox slots,
one flag word a rank and the epoch counter, made with ``cudaMalloc``, the
peers' opened through CUDA IPC. Every pair of the mesh's cards must reach
each other's memory (``cudaDeviceCanAccessPeer``): the setup raises, naming
the pair, where two cannot. Where a gather outgrows the mailbox outside a
capture, every rank makes a larger one there in a collective exchange of
the new handles (every rank reaches the same gather with the same shape; a
program's eager warm-up runs every gather before its capture); the earlier
mailboxes stay mapped until the release, since graphs captured on them
replay them. A gather larger than the mailbox inside a capture raises. At
one rank a gather is one copy kernel and needs no mailbox. A rank that
waits for another past :data:`WAIT_SECONDS` traps in the kernel, and the
call raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from ..program import Counted
from . import _build

#: A rank's longest wait for another inside one gather before the kernel
#: traps. A trap ends the process's CUDA context, so the wait outlasts by far
#: how far the ranks drift apart between two gathers (one rank capturing a
#: program while another replays it, host work between two calls); NCCL's
#: watchdog in PyTorch waits 10 minutes.
WAIT_SECONDS = 60.0
#: The first mailbox slot's bytes; a larger mailbox's slot is a multiple of
#: :data:`GROW_BYTES`, and at least twice the last (a mesh keeps them all).
FIRST_SLOT_BYTES = 1 << 20
GROW_BYTES = 2 << 20

_HANDLE = 64  # sizeof(cudaIpcMemHandle_t)
_BUS = 16  # a PCI bus id, "0000:00:00.0" and its NUL


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"peer gather: {what} failed with cudaError_t {err}")


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


class PeerMailbox:
    """This rank's buffers of a mesh's gather on ``dev``, the peers' mapped
    (module docstring). Made by every rank of ``group`` at once."""

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
        bus, flags = ctypes.create_string_buffer(_BUS), ctypes.create_string_buffer(_HANDLE)
        with torch.cuda.device(self.dev):
            _check(lib.loam_peer_bus_id(bus, _BUS), "reading the card's PCI bus id")
            _check(lib.loam_peer_flags_handle(self.handle, flags), "cudaIpcGetMemHandle of the flags")
        box = self._new_mailbox(lib, FIRST_SLOT_BYTES)
        every = _exchange(self.group, self.dev, bus.raw + flags.raw + box)
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
            _check(lib.loam_peer_mailbox(self.handle, cap, box), f"a mailbox of 2 x {cap} bytes")
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
        """A mailbox slot of at least ``nbytes`` past one rank: a larger
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

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The kernel's gather of the contiguous CUDA tensor ``x`` (a
        leading axis of the same length on every rank)."""
        if self.handle is None:
            raise RuntimeError("peer gather: the mesh was released")
        _build.require(x, "x", (x.dtype,), device=self.dev)
        out = torch.empty((self.world * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        nbytes = x.numel() * x.element_size()
        self.reserve(nbytes)
        _build.launch(_build.lib().loam_peer_gather, "peer_gather", x, self.handle, x.data_ptr(), out.data_ptr(),
                      nbytes)
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


def peer_gather_reference(x: torch.Tensor, group) -> torch.Tensor:
    """Plain version: ``dist.all_gather_into_tensor`` over ``group`` (bool
    travels as uint8: not every backend gathers bool)."""
    world = dist.get_world_size(group)
    wire = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    out = torch.empty((world * wire.shape[0],) + tuple(wire.shape[1:]), dtype=wire.dtype, device=wire.device)
    dist.all_gather_into_tensor(out, wire, group=group)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def peer_gather(x: torch.Tensor, mailbox, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along its leading axis in rank order:
    the kernel through ``mailbox`` (the mesh's :class:`PeerMailbox`) for a
    CUDA tensor, :func:`peer_gather_reference` over ``group`` for a CPU
    one."""
    if not x.is_cuda:
        return peer_gather_reference(x, group)
    if mailbox is None:
        raise ValueError("a CUDA tensor gathered on a mesh without a peer mailbox: make the mesh on its card "
                         "with make_mesh")
    out = mailbox.gather(x.contiguous())
    peer_gather.counter.add()
    return out


#: Kernel launches since the last reset (plain-version calls do not count;
#: read through conditional bodies, ``program.Counted``).
peer_gather = Counted(peer_gather)
