"""One driver call, one program on the card.

``loam_tpu`` compiles each driver call into one program: a registration is
one ``lax.while_loop`` (``loam_tpu/registration/icf.py:612``), a
scan-to-map frame one step of a ``lax.scan`` with the keyframe insert under
``lax.cond`` (``loam_tpu/odometry/scan_to_map.py:374``), a scan-to-scan
frame and a streaming chunk one jitted step. The port's twin is a
:class:`Program`: a function over buffers of its own, run eagerly on the
CPU and captured once into one CUDA graph on the card, then replayed, one
``cudaGraphLaunch`` a call and no host read.

* :func:`when` is ``lax.cond(pred, body, nothing)``: on the CPU (and on the
  card under :func:`eager`, the graphs' plain version) a host branch on
  ``bool(pred)``; under capture a CUDA-graph IF node on the device flag
  ``pred`` (``ops/csrc/graph_if.cu`` adds it with the CUDA runtime; the
  body is captured on a stream of its own into the node's body graph and
  allocates from a second memory pool of the program's). ``lax.while_loop`` bounded by ``max_iterations`` is its first
  iteration and then ``max_iterations - 1`` iterations, each under an IF
  node on the loop's ``any_running`` flag (``registration/loop.py``), which
  runs exactly the iterations the while loop runs.
* A value made inside an IF body and read after the node is ``copy_``'d
  into a buffer allocated before the node: a skipped body leaves the
  tensors it would have made undefined.
* Capture warms every branch up first: the function runs once eagerly with
  every :func:`when` body run regardless of its flag (kernel builds and
  loads, cuBLAS's workspace, cached constants; nothing may copy from the
  host inside a capture), then the inputs are copied in afresh.
* A program inside another (a registration inside a frame) runs inline:
  its work and its IF nodes land in the outer program.

Counts. A kernel wrapper (:class:`Counted`) and the ICF loop's iteration
count (a :class:`Counter`) stay exact through IF nodes: what runs
unconditionally is counted on the host (each replay adds what its capture
counted outside any IF body), what runs inside an IF body is counted by the
body itself, on the device, in a slot of that device's tally. A count is
read (one device read a device) only when someone reads it.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time

import torch

#: Slots of a device's tally: one a :class:`Counter`.
TALLY_SLOTS = 16

#: Programs kept per device, least recently used dropped first.
CACHE_KEYS = 6

#: The ``torch.profiler`` range around a driver's loop over frames or
#: chunks (one program launch each).
DRIVER_RANGE = "driver_loop"

_tallies: dict = {}  # device -> int64 (TALLY_SLOTS,) tensor
_cache: dict = {}  # device -> OrderedDict(key -> Program)
_mode = "eager"  # how when() runs a body: "eager", "warm" (always) or "capture" (an IF node)
_depth = 0  # programs running: one inside another runs inline
_eager_only = False
_if_nodes = 0  # IF nodes in the capture under way
_body_pool = None  # the torch.cuda.MemPool the capture's IF bodies allocate from
_body_streams: dict = {}  # device -> the raw stream IF bodies are captured on
_in_body = False  # an IF body is being captured (IF nodes do not nest)


class Counter:
    """A count: ``host`` what ran where the host knows it, plus the slot
    ``slot`` of every device's tally, what IF-node bodies ran there."""

    all: list = []

    def __init__(self, name: str):
        if len(Counter.all) >= TALLY_SLOTS:
            raise RuntimeError(f"more than {TALLY_SLOTS} counters")
        self.name, self.host, self.slot = name, 0, len(Counter.all)
        Counter.all.append(self)

    def add(self, n: int = 1) -> None:
        self.host += n

    @property
    def value(self) -> int:
        """The count; reads each device's slot (a sync there)."""
        return self.host + sum(int(t[self.slot]) for t in _tallies.values())

    def set(self, n: int) -> None:
        """Count from ``n``: the devices' slots are zeroed in stream order."""
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"counter {self.name} set during a capture")
        self.host = n
        for t in _tallies.values():
            t[self.slot].zero_()


class Counted:
    """A kernel wrapper with its launch count, ``launches`` (read and set as
    an int). The wrapper calls ``counter.add()`` where it launches its
    kernel, and nowhere else."""

    def __init__(self, fn):
        functools.update_wrapper(self, fn)
        self.counter = Counter(fn.__name__)

    def __call__(self, *args, **kwargs):
        return self.__wrapped__(*args, **kwargs)

    @property
    def launches(self) -> int:
        return self.counter.value

    @launches.setter
    def launches(self, n: int) -> None:
        self.counter.set(n)


def _tally(dev: torch.device) -> torch.Tensor:
    if dev not in _tallies:
        _tallies[dev] = torch.zeros(TALLY_SLOTS, dtype=torch.int64, device=dev)
    return _tallies[dev]


@contextlib.contextmanager
def eager():
    """Run every program inside eagerly, with host branches: the plain
    version the graphs are held against (``chip_smoke.py``, the ``cuda``
    tests), as a kernel is held against its plain version."""
    global _eager_only
    was, _eager_only = _eager_only, True
    try:
        yield
    finally:
        _eager_only = was


def nested() -> bool:
    """Whether a program is running: a program called now runs inline."""
    return _depth > 0


@contextlib.contextmanager
def _running(mode: str):
    global _mode, _depth
    was, _mode = _mode, mode
    _depth += 1
    try:
        yield
    finally:
        _mode = was
        _depth -= 1


def _make_body_stream(dev: torch.device) -> None:
    """The stream IF bodies are captured on, made before any capture (a
    stream cannot be created while one is under way). Bodies share it, and
    with it their freed blocks: a body runs after the one before it ended."""
    if dev in _body_streams:
        return
    import ctypes

    from .ops import _build

    handle = ctypes.c_void_p()
    with torch.cuda.device(dev):
        err = _build.lib().loam_stream_create(ctypes.byref(handle))
    if err != 0:
        raise RuntimeError(f"IF node: creating a body stream failed with cudaError_t {err}")
    _body_streams[dev] = handle.value


def when(pred: torch.Tensor, body) -> bool | None:
    """``lax.cond(pred, body, nothing)``: ``body()`` where the scalar bool
    ``pred`` holds. Eagerly a host branch, returning whether it ran; in a
    capture an IF node (``None``: the device decides at replay); during a
    capture's warm-up the body runs regardless (``None``). ``body``
    returns nothing: what it makes for later it ``copy_``'s into buffers
    allocated before."""
    global _if_nodes, _in_body
    if _mode == "warm":
        body()
        return None
    if _mode == "capture":
        from .ops import _build

        if _in_body:
            raise RuntimeError("IF nodes do not nest")
        lib, dev = _build.lib(), pred.device
        body_stream = _body_streams[dev]
        before = [c.host for c in Counter.all]
        _build.launch(lib.loam_if_begin, "IF node", pred, pred.data_ptr(), body_stream)
        _in_body = True
        try:
            # the body's capture is not the graph's: its allocations are
            # routed to a pool of the program's own
            with torch.cuda.stream(torch.cuda.ExternalStream(body_stream, device=dev)), \
                    torch.cuda.use_mem_pool(_body_pool, dev):
                body()
                # what the body launched is counted where it runs: on the device
                tally = _tally(dev)
                for c, n in zip(Counter.all, before):
                    if c.host != n:
                        tally[c.slot].add_(c.host - n)
                        c.host = n
        finally:
            _in_body = False
            err = lib.loam_if_end(body_stream)
        if err != 0:
            raise RuntimeError(f"IF node: ending the body's capture failed with cudaError_t {err}")
        _if_nodes += 1
        return None
    if bool(pred):
        body()
        return True
    return False


def alloc_like(tree):
    """Contiguous buffers shaped as ``tree``'s tensors; other leaves kept."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device=tree.device)
    if isinstance(tree, tuple):
        parts = [alloc_like(x) for x in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return tree


def copy_into(dst, src) -> None:
    """``dst``'s tensors ``copy_`` from ``src``'s, leaf by leaf; a ``None``
    in ``src`` keeps what ``dst`` holds there."""
    if src is None:
        return
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            copy_into(d, s)


def clone(tree):
    """``tree`` with every tensor cloned (results that own their storage)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple):
        parts = [clone(x) for x in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return tree


def signature(tree):
    """Shapes and dtypes of ``tree``'s tensors, its other leaves as they are:
    the part of a cache key that a capture bakes in from the inputs."""
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype
    if isinstance(tree, tuple):
        return tuple(signature(x) for x in tree)
    return tree


class Program:
    """One driver call's work over buffers of its own (``buffers``, shaped
    as the ``inputs`` it was made for): :meth:`run` copies a call's inputs
    in and runs the function, eagerly (CPU, or the card under
    :func:`eager`) or as one replay of its CUDA graph, captured at the first
    call on the card. ``capturable=False`` keeps it eager everywhere (a
    path that reads the host by design). ``info`` describes it in
    :func:`graph_stats`."""

    def __init__(self, dev: torch.device, inputs, capturable: bool = True, **info):
        self.dev, self.capturable, self.info = dev, capturable, info
        self.buffers = alloc_like(inputs)
        self.graph = None
        self.pools = None  # the graph's and its IF bodies' torch.cuda.MemPool
        self.out = None
        self.deltas = None  # host counts a replay adds
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        self.if_nodes = 0
        self.replays = 0

    def run(self, fn, inputs):
        """Copy ``inputs`` into the buffers (a ``None`` leaf keeps the
        buffer's contents: a carry the function updates in place) and
        return ``fn(buffers)``: fresh tensors eagerly, the graph's own
        through the graph (the next call overwrites them). A capture needs
        every input: it runs ``fn`` once to warm up."""
        if self.dev.type != "cuda" or _eager_only or not self.capturable:
            copy_into(self.buffers, inputs)
            with _running("eager"):
                return fn(self.buffers)
        if self.graph is None:
            self._capture(fn, inputs)
        copy_into(self.buffers, inputs)
        self.graph.replay()
        self.replays += 1
        for c, n in zip(Counter.all, self.deltas):
            c.host += n
        return self.out

    def own(self, out):
        """``out`` as the caller may keep it: the graph's own tensors
        cloned (the next replay overwrites them), fresh ones as they are."""
        return clone(out) if self.graph is not None and out is self.out else out

    def _capture(self, fn, inputs) -> None:
        """Warm ``fn`` up on a side stream with every IF body run, then
        capture it on that stream into one graph and pool. The counters
        are as before; ``deltas`` keeps what the capture counted outside
        any IF body."""
        global _if_nodes, _body_pool
        dev = self.dev
        saved = [c.host for c in Counter.all]
        t0 = time.perf_counter()
        _tally(dev)
        _make_body_stream(dev)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(stream):
                copy_into(self.buffers, inputs)
                with _running("warm"):
                    fn(self.buffers)
            torch.cuda.synchronize(dev)
            for c, n in zip(Counter.all, saved):
                c.host = n
            # a memory pool for the graph, and one for its IF bodies
            # (captured on streams of their own, into captures of their own)
            pool, body_pool = torch.cuda.MemPool(), torch.cuda.MemPool()
            graph = torch.cuda.CUDAGraph()
            _if_nodes, _body_pool = 0, body_pool
            with torch.cuda.graph(graph, pool=pool.id, stream=stream), _running("capture"):
                out = fn(self.buffers)
            torch.cuda.synchronize(dev)
            self.deltas = [c.host - n for c, n in zip(Counter.all, saved)]
        finally:
            _body_pool = None
            for c, n in zip(Counter.all, saved):
                c.host = n
        self.graph, self.pools, self.out, self.if_nodes = graph, (pool, body_pool), out, _if_nodes
        self.capture_seconds = time.perf_counter() - t0
        ids = {tuple(pool.id), tuple(body_pool.id)}
        self.pool_bytes = sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                              if tuple(s.get("segment_pool_id", ())) in ids)


def cached(dev: torch.device, key, inputs, **info) -> Program:
    """The program cached under ``key`` on ``dev`` (made for ``inputs`` if
    missing), now the most recently used; at most :data:`CACHE_KEYS` a
    device."""
    progs = _cache.setdefault(dev, collections.OrderedDict())
    prog = progs.pop(key, None)
    if prog is None:
        prog = Program(dev, inputs, **info)
    progs[key] = prog
    while len(progs) > CACHE_KEYS:
        progs.popitem(last=False)
    return prog


def clear_cache() -> None:
    """Drop every cached program and its graph."""
    _cache.clear()


def graph_stats() -> list:
    """One dict per captured program: what it is (``info``: its path and
    shapes), its IF nodes, capture seconds (warm-up included), the graph's
    memory pool in bytes and the replays since it was captured."""
    return [{"device": str(dev), **prog.info, "if_nodes": prog.if_nodes,
             "capture_s": prog.capture_seconds, "pool_bytes": prog.pool_bytes,
             "replays": prog.replays}
            for dev, progs in _cache.items() for prog in progs.values() if prog.graph is not None]
