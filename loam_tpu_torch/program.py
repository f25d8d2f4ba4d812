"""One driver call, one program on the card.

``loam_tpu`` compiles each driver call into one program: a trajectory of
``odometry_offline`` or ``scan_to_map_offline`` is one ``jax.jit`` around a
``lax.scan`` over chunks or frames (``loam_tpu/odometry/offline.py:32-141``,
``loam_tpu/odometry/scan_to_map.py:395-467``), a registration inside it one
``lax.while_loop`` (``loam_tpu/registration/icf.py:612``), the keyframe
insert a ``lax.cond``; a scan-to-scan frame and a streaming chunk are one
jitted step each. The port's twin is a :class:`Program`: a function over
buffers of its own, run eagerly on the CPU and captured once into one CUDA
graph on the card, then replayed, one ``cudaGraphLaunch`` a call and no
host read.

* :func:`when` is ``lax.cond(pred, body, nothing)``, :func:`while_loop` is
  ``lax.while_loop`` on a device flag the body updates, :func:`scan` is
  ``lax.scan`` over a device counter the body reads, its outputs stacked. On
  the CPU (and on the card under :func:`eager`, the graphs' plain version)
  they are host branches and host loops (a while loop reads its flag before
  each iteration); under capture each is one CUDA-graph conditional node, an
  IF node or a WHILE node, on a device flag (``ops/csrc/graph_if.cu`` adds
  them with the CUDA runtime). The body is captured on a stream of its own
  into the node's body graph and allocates from a second memory pool of the
  program's. Conditional nodes nest (a registration's WHILE node and a
  keyframe's IF node inside the WHILE node of a scan over frames).
* :func:`branches` is a mesh's shards side by side, as ``loam_tpu``'s
  devices run their blocks of a ``shard_map`` at once: eagerly a host loop
  in order; on the card each branch runs on a stream of its own, forked
  from the current stream and joined back, so a capture holds the branches
  as parallel paths of its graph (or of a conditional node's body), which
  the card runs at once.
* Lanes. What a stream enqueues belongs to a lane: the program's own
  stream is lane ``()``, branch ``b`` of a fork in lane ``l`` at body depth
  ``d`` is lane ``l + ((d, b),)`` (a stream that joined a capture stays in
  it until it ends, so a body forks onto other streams than the graph
  around it). A lane has its branch stream, a body stream a nesting depth,
  and a row of the tally; all are made before any capture (a stream cannot
  be created while one is under way), the root lane's with the capture,
  the branches' in its warm-up, which forks onto the same streams. The
  allocator keeps a stream's freed blocks for that stream, so a lane's
  bodies of one depth reuse each other's blocks (they run one after
  another: a lane is a chain of the graph) and two lanes never share one
  (their branches run at once).
* A value made inside a body and read after the node, or carried from one
  iteration to the next, lives in a buffer allocated before the node and is
  ``copy_``'d: a skipped body leaves the tensors it would have made
  undefined, and a WHILE body replays its allocations at the same addresses
  every iteration. :func:`scan` writes its stacked outputs into buffers
  that the capture's warm-up allocated (the warm-up's run of the same scan
  knows their shapes, and its branches run in the capture's order), which
  the program keeps.
* Capture warms every branch up first: the function runs once eagerly with
  every body run once regardless of its flag (kernel builds and loads,
  cuBLAS's workspace a stream, cached constants; nothing may copy from the
  host inside a capture), then the inputs are copied in afresh.
* A program inside another (a registration inside a frame, the extraction
  inside a trajectory) runs inline: its work and its conditional nodes land
  in the outer program.

Counts. A kernel wrapper (:class:`Counted`) and the ICF loop's iteration
count (a :class:`Counter`) stay exact through conditional nodes: what runs
unconditionally is counted on the host (each replay adds what its capture
counted outside any body), what runs inside a body is counted by the body
itself, on the device, in a slot of its lane's row of the tally, once each
time the body runs (branches that run at once add to rows of their own: no
add is lost). A count is read (one device read a lane) only when someone
reads it.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import time

import torch

#: Slots of a device's tally: one a :class:`Counter`.
TALLY_SLOTS = 16

#: Programs kept per device, least recently used dropped first.
CACHE_KEYS = 6

#: Conditional bodies one inside another, at most (a body stream each).
MAX_DEPTH = 4

#: The ``torch.profiler`` range around a driver's loop over frames or
#: chunks (one program launch each).
DRIVER_RANGE = "driver_loop"

_lanes: dict = {}  # (device, lane) -> _Lane
_lane: tuple = ()  # the lane whose work is enqueued now
_cache: dict = {}  # device -> OrderedDict(key -> Program)
_mode = "eager"  # how bodies run: "eager", "warm" (once, always) or "capture" (a conditional node)
_depth = 0  # programs running: one inside another runs inline
_eager_only = False
_conditional: dict = {}  # conditional nodes by type in the capture under way
_body_nodes = 0  # nodes of the capture under way's body graphs
_body_width = 1  # the widest fork of the capture under way's body graphs
_forks: list = []  # the capture under way's forks: each one's branches, as its join counted them
_body_pool = None  # the torch.cuda.MemPool the capture's bodies allocate from
_body_depth = 0  # bodies being captured, one inside another
_scan_outputs: list = []  # the stacked outputs of a warm-up's scans, in call order


class Counter:
    """A count: ``host`` what ran where the host knows it, plus the slot
    ``slot`` of every device's tally, what conditional bodies ran there."""

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
        """The count; reads each lane's slot (a sync on its device)."""
        return self.host + sum(int(lane.tally[self.slot]) for lane in _lanes.values())

    def set(self, n: int) -> None:
        """Count from ``n``: every lane's slot is zeroed in stream order."""
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"counter {self.name} set during a capture")
        self.host = n
        for lane in _lanes.values():
            lane.tally[self.slot].zero_()


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


def capturing_body() -> bool:
    """Whether the body of a conditional node is being captured now."""
    return _mode == "capture" and _body_depth > 0


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


class _Lane:
    """A lane's own on one device (the module docstring): the raw stream its
    branch runs on (``None`` for the root lane, whose work is the program's
    stream's) and its ``ExternalStream``, the raw streams its bodies are
    captured on (one a nesting depth: a lane's bodies of a depth run one
    after another, so they share that stream and its freed blocks), an
    event its forks record, an event its branch's join records, and its
    row of the tally. Made outside any capture."""

    def __init__(self, dev: torch.device, root: bool):
        from .ops import _build

        lib = _build.lib()

        def made(create, what):
            handle = ctypes.c_void_p()
            with torch.cuda.device(dev):
                err = create(ctypes.byref(handle))
            if err != 0:
                raise RuntimeError(f"creating {what} failed with cudaError_t {err}")
            return handle.value

        self.stream = None if root else made(lib.loam_stream_create, "a branch stream")
        self.external = None if root else torch.cuda.ExternalStream(self.stream, device=dev)
        self.bodies = [made(lib.loam_stream_create, "a body stream") for _ in range(MAX_DEPTH)]
        self.fork = made(lib.loam_event_create, "a fork event")
        self.join = made(lib.loam_event_create, "a join event")
        self.tally = torch.zeros(TALLY_SLOTS, dtype=torch.int64, device=dev)


def _lane_at(dev: torch.device, key: tuple) -> _Lane:
    """Lane ``key`` on ``dev``, made if missing (never during a capture:
    the capture's warm-up made every lane it forks onto)."""
    lane = _lanes.get((dev, key))
    if lane is None:
        if _mode == "capture":
            raise RuntimeError(f"lane {key} on {dev} was not made before the capture")
        lane = _lanes[(dev, key)] = _Lane(dev, root=not key)
    return lane


@contextlib.contextmanager
def _body(kind: str, flag: torch.Tensor):
    """Capture what runs inside as the body of one conditional node of
    ``kind`` (``"if"`` or ``"while"``) on the scalar bool device ``flag``,
    added to the graph the current stream captures; a WHILE body ends with
    a kernel that copies ``flag`` (which the body updates) into the node's
    condition. What the body launched is counted where it runs: on the
    device. A node that cannot be added raises."""
    global _body_depth, _body_nodes, _body_width
    from .ops import _build

    if _body_depth >= MAX_DEPTH:
        raise RuntimeError(f"conditional nodes nest at most {MAX_DEPTH} deep")
    lib, dev = _build.lib(), flag.device
    lane = _lanes[(dev, _lane)]
    body_stream = lane.bodies[_body_depth]
    before = [c.host for c in Counter.all]
    handle, nodes, width = ctypes.c_ulonglong(), ctypes.c_size_t(), ctypes.c_size_t()
    what = f"{kind.upper()} node"
    if kind == "while":
        _build.launch(lib.loam_while_begin, what, flag, flag.data_ptr(), body_stream, ctypes.byref(handle))
    else:
        _build.launch(lib.loam_if_begin, what, flag, flag.data_ptr(), body_stream)
    # the body's capture is not the graph's: the outermost body routes its
    # allocations, and those of the bodies inside it, to a pool of the program's
    pool = torch.cuda.use_mem_pool(_body_pool, dev) if _body_depth == 0 else contextlib.nullcontext()
    _body_depth += 1
    try:
        with torch.cuda.stream(torch.cuda.ExternalStream(body_stream, device=dev)), pool:
            yield
            for c, n in zip(Counter.all, before):
                if c.host != n:
                    lane.tally[c.slot].add_(c.host - n)
                    c.host = n
    finally:
        _body_depth -= 1
        if kind == "while":
            err = lib.loam_while_end(flag.data_ptr(), handle, body_stream, ctypes.byref(nodes),
                                     ctypes.byref(width))
        else:
            err = lib.loam_if_end(body_stream, ctypes.byref(nodes), ctypes.byref(width))
    if err != 0:
        raise RuntimeError(f"{what}: ending the body's capture failed with cudaError_t {err}")
    _conditional[kind] += 1
    _body_nodes += nodes.value
    _body_width = max(_body_width, width.value)


@contextlib.contextmanager
def _inline_body():
    """A body run inline in a capture's warm-up, at the depth its capture
    will capture it: its forks make the lanes the capture forks onto."""
    global _body_depth
    _body_depth += 1
    try:
        yield
    finally:
        _body_depth -= 1


def when(pred: torch.Tensor, body) -> bool | None:
    """``lax.cond(pred, body, nothing)``: ``body()`` where the scalar bool
    ``pred`` holds. Eagerly a host branch, returning whether it ran; in a
    capture an IF node (``None``: the device decides at replay); during a
    capture's warm-up the body runs regardless (``None``). ``body``
    returns nothing: what it makes for later it ``copy_``'s into buffers
    allocated before."""
    if _mode == "warm":
        with _inline_body():
            body()
        return None
    if _mode == "capture":
        with _body("if", pred):
            body()
        return None
    if bool(pred):
        body()
        return True
    return False


def while_loop(flag: torch.Tensor, body) -> None:
    """``lax.while_loop``: ``body()`` as long as the scalar bool ``flag``
    holds, checked before each iteration; ``body`` updates ``flag`` and its
    carry in place (``copy_``) and returns nothing. Eagerly a host loop
    that reads the flag before each iteration and stops at the first false;
    in a capture one WHILE node; during a capture's warm-up the body runs
    once, regardless."""
    if _mode == "warm":
        with _inline_body():
            body()
    elif _mode == "capture":
        with _body("while", flag):
            body()
    else:
        while bool(flag):
            body()


def branches(fns, device: torch.device) -> list:
    """Each of ``fns`` (functions of no argument) side by side, the shards
    of a mesh on one device as ``loam_tpu``'s devices run their blocks at
    once; returns their outputs in order. Eagerly (the CPU, and the card
    under :func:`eager`) a host loop in order: the plain version. On the
    card during a capture's warm-up and the capture, branch ``b`` runs on
    the stream of lane ``l + ((d, b),)`` (``l`` the lane forking, ``d`` the
    depth of the body it forks in, 0 outside any): the branch
    streams wait for what the current stream enqueued (the fork), the
    branches run in order on the host, and the current stream waits for
    each branch's end (the join); a capture holds them as parallel paths of
    its graph or of the conditional node's body under way, each with its
    own body streams, tally row and freed blocks. One function forks
    nothing. A fork or join that CUDA refuses raises with its
    ``cudaError_t``. The caller keeps collectives out of the branches: they
    come after the join, on the current stream."""
    global _lane
    fns = list(fns)
    if len(fns) < 2 or _mode == "eager":
        return [fn() for fn in fns]
    from .ops import _build

    lib, parent = _build.lib(), _lane
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    # a stream that joined a capture stays in it until it ends: a body's
    # forks go to lanes of the body's depth, not to those of the graph around it
    keys = [parent + ((_body_depth, b),) for b in range(len(fns))]
    lanes = [_lane_at(device, key) for key in keys]
    n = len(lanes)
    streams = (ctypes.c_void_p * n)(*[lane.stream for lane in lanes])
    joins = (ctypes.c_void_p * n)(*[lane.join for lane in lanes])
    here = torch.cuda.current_stream(device).cuda_stream
    err = lib.loam_fork(_lane_at(device, parent).fork, streams, n, here)
    if err != 0:
        raise RuntimeError(f"forking {n} branches failed with cudaError_t {err}")
    outs = []
    try:
        for key, lane, fn in zip(keys, lanes, fns):
            _lane = key
            with torch.cuda.stream(lane.external):
                outs.append(fn())
    finally:
        _lane = parent
    deps = ctypes.c_size_t()
    err = lib.loam_join(joins, streams, n, ctypes.byref(deps), here)
    if err != 0:
        raise RuntimeError(f"joining {n} branches failed with cudaError_t {err}")
    if _mode == "capture":
        _forks.append(deps.value)
    return outs


def scan(n: int, body, device: torch.device):
    """``lax.scan`` over ``n`` iterations: ``body(i)`` with ``i`` the
    iteration's index, an int64 scalar on ``device`` that the body reads
    (``index_select``, arithmetic), never on the host. What ``body``
    returns (a tensor, or tuples of them) is stacked on a new leading axis
    of ``n``; its carry it keeps in buffers allocated before and updates in
    place. Eagerly a host loop (no read of the device); in a capture one
    WHILE node on ``i < n``, writing into the buffers that the same scan
    allocated in the capture's warm-up. Returns the stacked outputs, or
    None for ``n <= 0`` (nothing ran to take their shapes from). A body
    that returns None scans its carry only and stacks nothing (the pose
    graph's LM iterations)."""
    if n <= 0:
        return None
    i = torch.zeros((), dtype=torch.int64, device=device)
    if _mode == "warm":
        slot = len(_scan_outputs)
        _scan_outputs.append(None)
    # allocated in the body, the buffers would share addresses with the
    # body's temporaries, which each iteration writes anew
    ys = _scan_outputs.pop(0) if _mode == "capture" else None

    def step():
        nonlocal ys
        y = body(i)
        if ys is None:
            ys = _stacked(y, n)
        _put(ys, i, y)
        i.add_(1)

    if _mode == "eager":
        for _ in range(n):
            step()
        return ys
    going = torch.ones((), dtype=torch.bool, device=device)

    def looped():
        step()
        torch.lt(i, n, out=going)

    while_loop(going, looped)
    if _mode == "warm":
        _scan_outputs[slot] = ys
    return ys


def _stacked(tree, n: int):
    """Buffers for ``n`` of ``tree``'s tensors stacked; other leaves kept."""
    if isinstance(tree, torch.Tensor):
        return torch.empty((n,) + tuple(tree.shape), dtype=tree.dtype, device=tree.device)
    if isinstance(tree, tuple):
        parts = [_stacked(x, n) for x in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return tree


def _put(ys, i: torch.Tensor, y) -> None:
    """Row ``i`` (a device scalar) of ``ys``'s tensors from ``y``'s."""
    if isinstance(ys, torch.Tensor):
        ys.index_copy_(0, i.view(1), y.unsqueeze(0))
    elif isinstance(ys, tuple):
        for a, b in zip(ys, y):
            _put(a, i, b)


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


def _tensors(tree) -> list:
    """``tree``'s tensors, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for part in tree for x in _tensors(part)]
    return []


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
        self.pools = None  # the graph's and its bodies' torch.cuda.MemPool
        self.out = None
        self.deltas = None  # host counts a replay adds
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        self.conditional = {}  # conditional nodes by type: "if", "while"
        self.nodes = 0  # the graph's nodes, its bodies' counted once each
        self.branches = 1  # the widest fork of the graph and its bodies
        self.forks = []  # each fork's branches, in capture order, as its join counted them
        self.scan_outputs = []  # what the graph's scans write, allocated in the warm-up
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
            # the capture's syncs, streams and pools on the program's card,
            # whichever card is current (a rank touches no other card)
            with torch.cuda.device(self.dev):
                self._capture(fn, inputs)
        copy_into(self.buffers, inputs)
        self.graph.replay()
        self.replays += 1
        for c, n in zip(Counter.all, self.deltas):
            c.host += n
        return self.out

    @property
    def if_nodes(self) -> int:
        """Conditional nodes of either type (IF and WHILE)."""
        return sum(self.conditional.values())

    def own(self, out):
        """``out`` as the caller may keep it: the graph's own tensors
        cloned (the next replay overwrites them), fresh ones as they are."""
        return clone(out) if self.graph is not None and out is self.out else out

    def _capture(self, fn, inputs) -> None:
        """Warm ``fn`` up on a side stream with every body run once, then
        capture it on that stream into one graph and pool. The counters
        are as before; ``deltas`` keeps what the capture counted outside
        any body."""
        global _conditional, _body_nodes, _body_width, _forks, _body_pool
        from .ops import _build

        dev = self.dev
        saved = [c.host for c in Counter.all]
        t0 = time.perf_counter()
        _lane_at(dev, ())
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        _scan_outputs.clear()
        try:
            with torch.cuda.stream(stream):
                copy_into(self.buffers, inputs)
                with _running("warm"):
                    fn(self.buffers)
            torch.cuda.synchronize(dev)
            scan_outputs = list(_scan_outputs)
            for c, n in zip(Counter.all, saved):
                c.host = n
            # a memory pool for the graph, and one for its bodies (captured
            # on streams of their own, into captures of their own)
            pool, body_pool = torch.cuda.MemPool(), torch.cuda.MemPool()
            graph = torch.cuda.CUDAGraph()
            _conditional, _body_nodes, _body_pool = {"if": 0, "while": 0}, 0, body_pool
            _body_width, _forks = 1, []
            top, width = ctypes.c_size_t(), ctypes.c_size_t()
            with torch.cuda.graph(graph, pool=pool.id, stream=stream), _running("capture"):
                out = fn(self.buffers)
                err = _build.lib().loam_capture_nodes(stream.cuda_stream, ctypes.byref(top))
                err = err or _build.lib().loam_capture_width(stream.cuda_stream, ctypes.byref(width))
            if err != 0:
                raise RuntimeError(f"counting the graph's nodes failed with cudaError_t {err}")
            if _scan_outputs:
                raise RuntimeError("the capture ran fewer scans than its warm-up")
            torch.cuda.synchronize(dev)
            self.deltas = [c.host - n for c, n in zip(Counter.all, saved)]
        finally:
            _body_pool = None
            _scan_outputs.clear()
            for c, n in zip(Counter.all, saved):
                c.host = n
        self.graph, self.pools, self.out = graph, (pool, body_pool), out
        self.conditional, self.nodes = dict(_conditional), top.value + _body_nodes
        self.branches, self.forks = max(width.value, _body_width), list(_forks)
        self.scan_outputs = scan_outputs
        self.capture_seconds = time.perf_counter() - t0
        ids = {tuple(pool.id), tuple(body_pool.id)}
        self.pool_bytes = sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                              if tuple(s.get("segment_pool_id", ())) in ids)
        self.pool_bytes += sum(x.numel() * x.element_size() for x in _tensors(scan_outputs))


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


def forget(**info) -> None:
    """Drop the cached programs whose ``info`` holds every item of ``info``
    (a mesh's, by its token, before its process group is destroyed)."""
    for progs in _cache.values():
        for key in [k for k, p in progs.items() if all(p.info.get(n) == v for n, v in info.items())]:
            del progs[key]


def graph_stats() -> list:
    """One dict per captured program: what it is (``info``: its path and
    shapes), its conditional nodes (``if_nodes``: IF and WHILE together;
    ``conditional_nodes``: by type), its nodes (``nodes``: the graph's and
    each body's once, however often a body runs), its widest fork
    (``branches``: of the graph and every body graph, the most nodes that
    depend on one node or the root nodes, through the CUDA graph API; 1 for
    a chain) and each :func:`branches` fork's width as its join counted the
    branches' ends (``forks``, in capture order), capture seconds (warm-up
    included), the bytes of its memory pools and of its scans' outputs, and
    the replays since it was captured."""
    return [{"device": str(dev), **prog.info, "if_nodes": prog.if_nodes,
             "conditional_nodes": prog.conditional, "nodes": prog.nodes,
             "branches": prog.branches, "forks": prog.forks,
             "capture_s": prog.capture_seconds, "pool_bytes": prog.pool_bytes,
             "replays": prog.replays}
            for dev, progs in _cache.items() for prog in progs.values() if prog.graph is not None]
