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
makes it, every rank at once; ``Mesh.release`` frees it). A rank's peers are
on its island -- the ranks of its host whose cards reach each other's
memory (``cudaDeviceCanAccessPeer``) -- or remote: every other rank, on
another host or on a card this one cannot reach (:func:`islands`). A host is
a rank's label: ``make_mesh(hosts=)``, one a rank, or by default its machine
(:func:`machine`: the host name and the boot id), so PCI bus ids are
compared, and CUDA IPC handles opened, only between ranks of one host.

  * Island: a mailbox of two slots of one region an island member, in
    device memory (``cudaMalloc``), mapped by the island's peers through
    CUDA IPC, and the control words (a flag a sender and chunk, an
    acknowledgement a rank, the epoch); the kernel pushes over NVLink.
  * Remote: for each remote peer two slots out and two in of
    :data:`STAGE_BYTES` each of pinned host memory mapped for the card
    (``cudaHostAlloc``), made once with the mesh, and the words of
    ``csrc/peer_link.h``; the kernel stages its chunks there over PCIe and
    the rank's proxy (``csrc/peer_proxy.cpp``, C++, no CUDA call, no
    Python in its loops; a sending and a receiving thread a remote peer)
    moves them over TCP to the peer's proxy, a run of consecutive raised
    chunks a message (one ``sendmsg``), which lands them in that rank's
    staging and raises their flags; each link counts its messages, bytes,
    calls and time (:meth:`PeerMailbox.link_counters`). A collective that
    would send a remote peer more than a slot holds runs in pieces, each
    an epoch of the same protocol within the one launch, so a rank pins
    4 x :data:`STAGE_BYTES` and 384 KB of words a remote peer whatever
    the payloads (64 MB a remote peer: 1 GB at 3 hosts x 8 ranks), where
    staging sized by the payload grew as remote peers x the largest
    payload (a gather of the pose graph's H, 288 MB a rank, at 2 hosts x
    8: 9.2 GB a rank).

Each rank's proxy listens on an ephemeral TCP port at the address that
``LOAM_PEER_ADDR`` names, else at 127.0.0.1 where every remote peer of the
rank runs on its machine, else at the address its host name resolves to
(which must not be a loopback address: set ``LOAM_PEER_ADDR`` then); the
ranks exchange addresses and ports through the group, each rank connects to
its remote peers above it and accepts those below (within
:data:`CONNECT_SECONDS`, or ``make_mesh`` raises). Where a payload
outgrows the regions outside a capture, every rank makes a larger mailbox
there in a collective exchange of the new handles (every rank
reaches the same collective with the same shapes; a program's eager warm-up
runs every collective before its capture); the earlier ones stay until the
release, since graphs captured on them replay them. A payload larger than
the region inside a capture raises. At one rank the gather is one copy
kernel, the sum one kernel that reads the L blocks and writes one, and
neither needs a mailbox. A rank that waits for another past
:data:`WAIT_SECONDS` traps in the kernel, and the call raises (the longest
wait so far: :meth:`PeerMailbox.max_wait`); a proxy that
loses its socket raises the rank's abort word, which the kernel's spin
reads (it traps at once), and the next call raises naming the link. There
is no fallback: a mesh across hosts never turns to eager NCCL or gloo.

No constant caps the world: the kernel's routes are a table in device
memory, its control words are sized by the island, and a block keeps 24
bytes a rank in shared memory, so a mesh takes up to
``loam_peer_world_max()`` ranks (2,048, the 48 KB of shared memory a launch
takes without opting in). What a world needs is memory, which
:meth:`PeerMailbox.footprint` reports and whose failure to allocate raises
naming the bytes: the mailbox, 2 x the island's ranks x the largest
payload of device memory, and the staging above.
"""

from __future__ import annotations

import ctypes
import os
import secrets
import socket
import struct

import torch
import torch.distributed as dist

from ..program import Counted
from . import _build

#: A rank's longest wait for another inside one collective before the
#: kernel traps (ranks that share a card wait out each other's time slices
#: too). A trap ends the process's CUDA context, so the wait outlasts
#: by far how far the ranks drift apart between two collectives (one rank
#: capturing a program while another replays it, host work between two
#: calls); NCCL's watchdog in PyTorch waits 10 minutes.
WAIT_SECONDS = 60.0
#: Bytes of a remote peer's staging slot (two out and two in, pinned): what
#: one epoch sends a remote peer at most; a collective that would send more
#: runs in pieces of it.
STAGE_BYTES = 16 << 20
#: The first mailbox's region (a rank's payload) in bytes; a larger
#: mailbox's region is a multiple of :data:`GROW_BYTES`, and at least twice
#: the last (a mesh keeps them all). A mailbox holds 2 regions an island
#: member.
FIRST_SLOT_BYTES = 1 << 20
GROW_BYTES = 2 << 20
#: Where each leaf of a gather starts in the packed payload: a multiple of
#: this many bytes, so every leaf's block takes the kernel's 16-byte path.
ALIGN = 16
#: The dtypes the sum takes, as the kernel names them.
SUM_DTYPES = {torch.float32: 0, torch.float64: 1, torch.int32: 2, torch.int64: 3}

#: Seconds ``make_mesh`` waits to connect to and be reached by the remote
#: peers' proxies.
CONNECT_SECONDS = 60.0

#: What the proxy counts for each remote peer's link and direction
#: (:meth:`PeerMailbox.link_counters`), in ``csrc/peer_proxy.cpp``'s order:
#: data messages, the chunks and payload bytes they carried,
#: acknowledgements, ``send`` / ``recv`` calls and the seconds blocked in
#: them, the seconds the sender spent finding runs in the kernel's flags,
#: and the seconds asleep (the sender idle; the receiver, blocked in
#: ``recv``, never sleeps).
LINK_COUNTERS = ("messages", "chunks", "bytes", "acks", "syscalls", "blocked_s", "scan_s", "sleep_s")

_HANDLE = 64  # sizeof(cudaIpcMemHandle_t)
_BUS = 16  # a PCI bus id, "0000:00:00.0" and its NUL
_LABEL = 128  # a host's label or machine in the exchange
_ADDR = 64  # a proxy's address
_HELLO = b"loam peer proxy\0"  # a connection's first bytes, then the mesh's nonce and the rank
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


def takes_device_tensors(group) -> bool:
    """Whether ``group``'s collectives take CUDA tensors (NCCL's); gloo's
    take host tensors."""
    return "nccl" in str(dist.get_backend(group))


def _exchange(group, dev: torch.device, mine: bytes) -> list:
    """Every rank's ``mine`` (the same length on each), in rank order: one
    eager ``all_gather_into_tensor`` over ``group``, on the current stream,
    through the card where the group is NCCL's."""
    world = dist.get_world_size(group)
    on = dev if takes_device_tensors(group) else torch.device("cpu")
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


def machine() -> str:
    """This machine: its host name and its boot id
    (``/proc/sys/kernel/random/boot_id``). Two processes name the same
    machine exactly when they run on one booted host: identical servers
    share PCI bus ids, but not boot ids."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            boot = f.read().strip()
    except OSError:
        boot = "no boot id"
    return f"{socket.gethostname()}/{boot}"


def islands(labels, reach) -> tuple:
    """The mesh's islands from each rank's host label and ``reach(a, b)``
    (whether ranks a and b's cards reach each other's memory, both ways;
    asked only of ranks with one label): a rank joins the first island of
    its label whose every member it reaches, else starts one. Tuples of
    ranks in rank order; every rank computes the same from the same
    exchange."""
    out = []
    for r, label in enumerate(labels):
        for isl in out:
            if labels[isl[0]] == label and all(reach(r, m) for m in isl):
                isl.append(r)
                break
        else:
            out.append([r])
    return tuple(tuple(isl) for isl in out)


def check_hosts(hosts, world: int) -> tuple:
    """``make_mesh``'s ``hosts`` as labels, one a rank: a sequence of
    ``world`` labels (any values; equal labels, one host)."""
    labels = tuple(str(h) for h in hosts)
    if len(labels) != world:
        raise ValueError(f"hosts= gives {len(labels)} labels for {world} ranks: one a rank")
    if any(len(x.encode()) > _LABEL - 1 for x in labels):
        raise ValueError(f"a host label takes at most {_LABEL - 1} bytes")
    return labels


def _field(text: str, size: int) -> bytes:
    raw = text.encode()
    if len(raw) >= size:
        raise ValueError(f"{text!r} is longer than {size - 1} bytes")
    return raw + b"\0" * (size - len(raw))


def _text(raw: bytes) -> str:
    return raw.split(b"\0", 1)[0].decode()


def _address(machines: list, remote: list, me: str) -> str:
    """Where this rank's proxy listens (the module docstring)."""
    if os.environ.get("LOAM_PEER_ADDR"):
        return os.environ["LOAM_PEER_ADDR"]
    if all(machines[t] == me for t in remote):
        return "127.0.0.1"
    addr = socket.gethostbyname(socket.gethostname())
    if addr.startswith("127."):
        raise RuntimeError(f"peer gather: this rank's remote peers include another machine, and its host name "
                           f"resolves to the loopback address {addr}: set LOAM_PEER_ADDR to this machine's address "
                           f"on the network the ranks share")
    return addr


def _read(sock, n: int) -> bytes:
    got = b""
    while len(got) < n:
        part = sock.recv(n - len(got))
        if not part:
            raise ConnectionError("the peer closed the connection")
        got += part
    return got


class PeerMailbox:
    """This rank's buffers of a mesh's collectives on ``dev``, the island
    peers' mapped, and its proxy to the remote ones (module docstring).
    Made by every rank of ``group`` at once; ``hosts``: one label a rank
    (``make_mesh``), or None for each rank's machine."""

    def __init__(self, group, dev: torch.device, hosts=None):
        self.group, self.dev = group, dev
        self.world, self.rank = dist.get_world_size(group), dist.get_rank(group)
        lib = _build.lib()
        if self.world > lib.loam_peer_world_max():
            raise ValueError(f"the peer gather takes at most {lib.loam_peer_world_max()} ranks (24 bytes a rank of a "
                             f"block's 48 KB of shared memory), the group has {self.world}")
        given = None if hosts is None else check_hosts(hosts, self.world)
        handle = ctypes.c_void_p()
        self.window = STAGE_BYTES
        with torch.cuda.device(dev):
            _check(lib.loam_peer_create(self.world, self.rank, WAIT_SECONDS, self.window, ctypes.byref(handle)),
                   "creating")
        self.handle, self.cap = handle.value, 0
        self.buses, self.hosts, self.islands, self.remote = [b"?"] * self.world, (machine(),), ((0,),), []
        try:
            self._setup(lib, given)
        except BaseException:
            with torch.cuda.device(dev):
                lib.loam_peer_close(self.handle)
                lib.loam_peer_free(self.handle)
            self.handle = None
            raise

    def _setup(self, lib, given) -> None:
        if self.world == 1:
            self.hosts = given or self.hosts
            return
        me, world, rank = machine(), self.world, self.rank
        bus = ctypes.create_string_buffer(_BUS)
        with torch.cuda.device(self.dev):
            _check(lib.loam_peer_bus_id(bus, _BUS), "reading the card's PCI bus id")
        label = given[rank] if given else me
        every = _exchange(self.group, self.dev, _field(label, _LABEL) + _field(me, _LABEL) + bus.raw +
                          secrets.token_bytes(8))
        labels = tuple(_text(e[:_LABEL]) for e in every)
        machines = [_text(e[_LABEL:2 * _LABEL]) for e in every]
        self.buses = [e[2 * _LABEL:2 * _LABEL + _BUS] for e in every]
        nonce = every[0][-8:]
        self.hosts = labels
        if given and labels != given:
            raise ValueError(f"the ranks' hosts= differ: this rank's {list(given)}, each rank's own label "
                             f"{list(labels)}")
        for a in range(world):
            for b in range(a + 1, world):
                if labels[a] == labels[b] and machines[a] != machines[b]:
                    raise ValueError(f"host {labels[a]!r} names ranks {a} and {b}, which run on two machines "
                                     f"({machines[a]}, {machines[b]})")
        # this rank's card against every card of its host, both ways; -1
        # (this process does not see one of them) leaves it to the IPC open
        row = bytearray(world)
        with torch.cuda.device(self.dev):
            for t in range(world):
                if labels[t] == label:
                    ok = ctypes.c_int()
                    _check(lib.loam_peer_can_reach(self.buses[rank], self.buses[t], ctypes.byref(ok)),
                           "cudaDeviceCanAccessPeer")
                    row[t] = ok.value != 0
        rows = _exchange(self.group, self.dev, bytes(row))
        self.islands = islands(labels, lambda a, b: rows[a][b] and rows[b][a])
        mine = next(isl for isl in self.islands if rank in isl)
        self.remote = [t for t in range(world) if t not in mine]
        with torch.cuda.device(self.dev):
            pinned = len(self.remote) * (4 * self.window + lib.loam_proxy_link_bytes()) + (64 if self.remote else 0)
            _check(lib.loam_peer_routes(self.handle, (ctypes.c_int * world)(*(t in mine for t in range(world)))),
                   f"the control words of an island of {len(mine)} and pinning {pinned} bytes for "
                   f"{len(self.remote)} remote peers' staging and words")
        listener, addr, port = None, "", 0
        try:
            if self.remote:
                addr = _address(machines, self.remote, me)
                listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                listener.bind((addr, 0))
                listener.listen(world)
                port = listener.getsockname()[1]
            ctl = ctypes.create_string_buffer(_HANDLE)
            with torch.cuda.device(self.dev):
                _check(lib.loam_peer_flags_handle(self.handle, ctl), "cudaIpcGetMemHandle of the control words")
            box = self._new_mailbox(lib, FIRST_SLOT_BYTES)
            every = _exchange(self.group, self.dev, ctl.raw + box + _field(addr, _ADDR) + struct.pack("<H", port))
            self._open(lib, b"".join(e[:2 * _HANDLE] for e in every))
            if self.remote:
                where = [(_text(e[2 * _HANDLE:2 * _HANDLE + _ADDR]), struct.unpack("<H", e[-2:])[0]) for e in every]
                fds = self._connect(listener, where, nonce)
                with torch.cuda.device(self.dev):
                    _check(lib.loam_peer_proxy(self.handle, (ctypes.c_int * world)(*fds)), "starting the proxy")
        finally:
            if listener is not None:
                listener.close()

    def _connect(self, listener, where: list, nonce: bytes) -> list:
        """A connected socket to each remote peer's proxy (this rank
        connects to those above it, accepts those below), as file
        descriptors by rank (-1 elsewhere), handed to the proxy."""
        socks, rank = {}, self.rank
        try:
            for t in self.remote:
                if t > rank:
                    sock = socket.create_connection(where[t], timeout=CONNECT_SECONDS)
                    socks[t] = sock
                    sock.sendall(_HELLO + nonce + struct.pack("<i", rank))
            lower = {t for t in self.remote if t < rank}
            listener.settimeout(CONNECT_SECONDS)
            while lower:
                sock, _ = listener.accept()
                sock.settimeout(CONNECT_SECONDS)
                hello = _read(sock, len(_HELLO) + len(nonce) + 4)
                r = struct.unpack("<i", hello[-4:])[0]
                if hello[:-4] != _HELLO + nonce or r not in lower:
                    sock.close()  # not one of this mesh's ranks
                    continue
                socks[r] = sock
                lower.discard(r)
        except OSError as err:
            for sock in socks.values():
                sock.close()
            missing = [t for t in self.remote if t not in socks]
            raise RuntimeError(f"peer gather: rank {rank} (host {self.hosts[rank]!r}) could not connect to the "
                               f"proxies of ranks {missing} ({[self.hosts[t] for t in missing]}): {err}") from err
        return [socks[t].detach() if t in socks else -1 for t in range(self.world)]

    def _new_mailbox(self, lib, cap: int) -> bytes:
        box = ctypes.create_string_buffer(_HANDLE)
        island = self.world - len(self.remote)
        with torch.cuda.device(self.dev):
            _check(lib.loam_peer_mailbox(self.handle, cap, box),
                   f"a mailbox of 2 x {island} regions of {cap} bytes ({2 * island * cap if island > 1 else 0} "
                   f"bytes of device memory)")
        self.cap = cap
        return box.raw

    def _open(self, lib, handles: bytes) -> None:
        failed = ctypes.c_int()
        with torch.cuda.device(self.dev):
            err = lib.loam_peer_open(self.handle, handles, ctypes.byref(failed))
        if err != 0:
            r, me = failed.value, self.rank
            them = f"{_name(self.buses[r])} on host {self.hosts[r]!r}" if r >= 0 else "?"
            raise RuntimeError(f"peer gather: rank {me} ({_name(self.buses[me])} on host {self.hosts[me]!r}) could "
                               f"not map rank {r}'s buffers ({them}) with cudaIpcOpenMemHandle: cudaError_t {err}; "
                               f"ranks of one host whose cards reach each other's memory share it through CUDA IPC")

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

    def check_links(self) -> None:
        """Raise where the proxy lost a link (its abort word is up): the
        kernel would trap at its first wait on a remote peer."""
        if not self.remote:
            return
        msg = ctypes.create_string_buffer(256)
        t = _build.lib().loam_peer_aborted(self.handle, msg, len(msg))
        if t:
            raise RuntimeError(f"peer gather: rank {self.rank} (host {self.hosts[self.rank]!r}) lost its link to "
                               f"rank {t - 1} (host {self.hosts[t - 1]!r}): {msg.value.decode(errors='replace')}")

    def link_counters(self) -> dict:
        """The proxy's counters of every remote peer's link since the mesh
        was made: ``{peer rank: {"send": {name: value}, "recv": {...}}}``
        (:data:`LINK_COUNTERS`; seconds as floats). Read from host memory
        after a call, never inside a graph; ``{}`` without a remote peer.
        The difference of two reads is what the collectives between them
        moved."""
        out = {}
        if not self.remote or self.handle is None:
            return out
        n = len(LINK_COUNTERS)
        raw = (ctypes.c_ulonglong * (2 * n))()
        lib = _build.lib()
        for t in self.remote:
            got = lib.loam_peer_link_counters(self.handle, t, raw)
            if got != n:
                raise RuntimeError(f"peer gather: the proxy keeps {got} counters a direction, the port names {n}")
            out[t] = {side: {name: raw[j * n + i] * (1e-9 if name.endswith("_s") else 1)
                             for i, name in enumerate(LINK_COUNTERS)} for j, side in enumerate(("send", "recv"))}
        return out

    def _run(self, what: str, t: torch.Tensor, segments: list, mode: int, dtype: int, total: int, L: int) -> None:
        if self.handle is None:
            raise RuntimeError("peer gather: the mesh was released")
        lib = _build.lib()
        if len(segments) > lib.loam_peer_max_segments():
            raise ValueError(f"peer gather: {len(segments)} leaves in one gather, at most "
                             f"{lib.loam_peer_max_segments()}")
        self.check_links()
        self.reserve(total if mode == _GATHER else (L + 1) * sum_slice(total, self.world))
        flat = (ctypes.c_longlong * (4 * len(segments)))(*(v for seg in segments for v in seg))
        try:
            _build.launch(lib.loam_peer_run, what, t, self.handle, flat, len(segments), mode, dtype, total, L)
        except RuntimeError:
            self.plan(mode, total, L)  # raises where a chunk outgrows a remote peer's staging slot
            raise

    def plan(self, mode: int, total: int, L: int = 1) -> dict:
        """How the kernel cuts a gather (``mode`` 0, ``total`` packed
        bytes a rank) or a sum (1, ``total`` bytes a block, ``L`` blocks a
        rank): bytes a chunk, chunks, pieces (an epoch each) and chunks a
        piece."""
        out = (ctypes.c_longlong * 4)()
        if _build.lib().loam_peer_plan(self.handle, mode, total, L, out) != 0:
            raise ValueError(f"peer gather: one chunk of a {'gather' if mode == _GATHER else f'sum of {L} blocks'} "
                             f"of {total} bytes a rank outgrows a remote peer's staging slot of {self.window} bytes")
        return dict(zip(("chunk", "chunks", "pieces", "piece_chunks"), out))

    def footprint(self) -> dict:
        """What this rank holds for the mesh: ``{"device": the control
        words, every mailbox and the route tables, "pinned": the remote
        peers' staging and words}`` in bytes."""
        if self.handle is None:
            return {"device": 0, "pinned": 0}
        out = (ctypes.c_ulonglong * 2)()
        _check(_build.lib().loam_peer_bytes(self.handle, out), "counting the buffers")
        return {"device": out[0], "pinned": out[1]}

    def max_wait(self) -> dict:
        """The longest wait of any spin of this rank's collectives since
        the mesh was made (a synchronous read: after a run, outside a
        capture): ``{"seconds": ..., "share": of WAIT_SECONDS}``, from
        cycles of ``clock64`` at the card's clock rate."""
        if self.handle is None:
            return {"seconds": 0.0, "share": 0.0}
        out = (ctypes.c_ulonglong * 2)()
        with torch.cuda.device(self.dev):
            _check(_build.lib().loam_peer_max_wait(self.handle, out), "reading the longest wait")
        share = out[0] / out[1] if out[1] else 0.0
        return {"seconds": share * WAIT_SECONDS, "share": share}

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
        """Unmap the island peers' buffers, wait for every rank to have
        unmapped this rank's and ended its last collective (every rank calls
        it, while the group lives; ``wait`` False skips that, for a group
        already destroyed), then stop the proxy and free them."""
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
    if wire.is_cuda and not takes_device_tensors(group):  # gloo gathers host tensors
        return _one_reference(x.cpu(), group).to(x.device)
    out = _gathered(wire, dist.get_world_size(group))
    dist.all_gather_into_tensor(out, wire, group=group)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def peer_gather_reference(x, group):
    """Plain version: ``dist.all_gather_into_tensor`` over ``group``, a
    leaf at a time (``x`` a tensor, or a list of them; a CUDA leaf through
    the host where the group is gloo's)."""
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
