"""The protocol of the mesh's collectives over peer memory
(``loam_tpu_torch/ops/csrc/peer_gather.cu``), as a pure-Python model.

The kernel runs only on a card; what can be checked here is its protocol.
Each rank's program is one kernel a collective (a gather or a sum), one
atomic step at a time:

  * read the epoch counter, ``e = epoch + 1``;
  * chunk by chunk, as a block of the kernel takes them, push chunk ``k``
    and then receive chunk ``k - 1`` (a sum: and collect chunk ``k - 2``);
  * push: before its first chunk, wait until every peer acknowledged epoch
    ``e - 2`` (the credit to rewrite slot ``e % 2``); then store the chunk
    into region ``rank`` of every peer's slot ``e % 2`` (a sum: the peer's
    slice of it), then store ``e`` into that peer's flag of (this rank,
    ``k``);
  * receive: a gather waits for each (sender, chunk) flag ``>= e`` on its
    own and copies that chunk out of its mailbox; a sum waits for every
    sender's flag of the chunk, then reads every shard's part of its own
    slice in global shard order (its own from its input), adds them, and
    pushes the sums to every peer as above with a second flag;
  * collect (a sum): wait for each peer's second flag of the chunk and copy
    its sums out of the mailbox;
  * store the epoch, then acknowledge ``e`` to every peer.

A collective may move nothing (every leaf empty: no chunk, no flag), yet it
steps the epoch and acknowledges like any other. Without the credit, a rank
two collectives ahead of a slow peer -- possible past an empty collective,
which waits for no one -- would rewrite the slot that peer still reads.

A mesh makes a larger mailbox where a payload outgrows it and keeps the
earlier ones: a graph captured on an earlier mailbox replays it after a
later one was made. Each collective names the mailbox it uses (the same on
every rank: they grow at the same collective and capture the same programs).

Across hosts (ranks with another host label), a push goes into the
sender's out staging for that peer and raises the peer's flag of the slot
there; the sender's proxy, an actor of its own a link, sends each
acknowledgement first, then a run: from a cursor of a slot and area, the
consecutive chunks of one epoch whose flags are up (a newer epoch's first
chunk moves the cursor to it; the slot of the lower epoch first), one
message, over an ordered channel (or several, in turn); the receiver's
proxy, an actor a channel, lands each chunk of the run in the receiver's
in staging, then raises its flag of the slot there, or stores the
acknowledgement. A flag a slot, not a chunk: the kernel may raise epoch
e + 1's flag before the proxy sent epoch e's.

``hypothesis`` draws the interleavings of 2 and 4 ranks over several
collectives, and each collective's kind, chunks (0 to 2) and mailbox. Every
rank's output of every collective must be, chunk by chunk, that collective's
blocks in rank order (a gather) or each slice's sum of every shard's part
added in global shard order (a sum), no
rank may write a region while a peer is reading it, no rank may touch a
freed mailbox, and every rank must end (no deadlock). The same model
without the credit wait, with one slot, with the flag stored before the
data, or freeing a rank's earlier mailboxes when it makes a new one, must
fail, which shows that the checks can fail. Across hosts it also draws
2-16 ranks on 1-4 hosts, and two channels a link on which an
acknowledgement may overtake a run (which is safe); the model where a
proxy raises a flag before it lands the chunk or a run's flags before its
bytes, where a run takes in a chunk of another epoch, where no
acknowledgement crosses the wire, or where a rank reuses a slot before the
remote acknowledgement (no credit wait for a remote peer) must fail on
some interleavings that the whole protocol passes.
"""

from collections import deque

import random

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

GATHERS = 5
CHUNKS = 2


class Mesh:
    """The ranks' device memory: mailboxes, flags, acknowledgements,
    epoch counters."""

    def __init__(self, world: int, slots: int, mailboxes: int, hosts=None, sockets: int = 1):
        self.world, self.slots = world, slots
        self.hosts = hosts or [0] * world
        # across hosts: out staging out[s][t][m][slot][area][k] (at s, for
        # t), its flags and chunk descriptions a slot (at s), the in
        # staging's flags a slot iflags[t][s][slot][area][k] (at t; the in
        # staging is mailbox[t][...][s]), the acknowledgement for the wire
        # ack_out[s][t], a link's channels chan[s][t][c] and its proxy's
        # cursors cursor[s][t][slot][area] = (epoch, next chunk)
        per = lambda f: [[f() for _ in range(world)] for _ in range(world)]
        area_k = lambda: [[0] * CHUNKS for _ in range(2)]
        self.out = per(lambda: [[[[None] * CHUNKS for _ in range(2)] for _ in range(slots)]
                                for _ in range(mailboxes)])
        self.oflags = per(lambda: [area_k() for _ in range(slots)])
        self.odesc = per(lambda: [[[None] * CHUNKS for _ in range(2)] for _ in range(slots)])
        self.iflags = per(lambda: [area_k() for _ in range(slots)])
        self.cursor = per(lambda: [[(0, CHUNKS)] * 2 for _ in range(slots)])
        self.last_area = per(lambda: 1)
        self.ack_out, self.ack_sent = per(int), per(int)
        self.chan = per(lambda: [deque() for _ in range(sockets)])
        # mailbox[t][m][slot][s][area][k]: chunk k of region s (sender s) of
        # rank t's mailbox m; area 0 a gather's payload or a sum's slices,
        # area 1 a sum's sums
        self.mailbox = [[[[[[None] * CHUNKS for _ in range(2)] for _ in range(world)] for _ in range(slots)]
                         for _ in range(mailboxes)] for _ in range(world)]
        # flags[t][s][phase][k], at t
        self.flags = [[[[0] * CHUNKS for _ in range(2)] for _ in range(world)] for _ in range(world)]
        self.acks = [[0] * world for _ in range(world)]  # acks[s][t], at s: what rank t acknowledged
        self.epoch = [0] * world
        self.made = [0] * world  # mailboxes each rank made
        self.freed = set()  # (rank, mailbox)
        self.reading = {}  # (rank, mailbox, slot, region, area, chunk) -> the readers inside it
        self.overwrites, self.after_free = [], []

    def remote(self, a: int, b: int) -> bool:
        return self.hosts[a] != self.hosts[b]

    def write(self, t, m, slot, s, area, k, value):
        if self.reading.get((t, m, slot, s, area, k)):
            self.overwrites.append((t, m, slot, s, area, k))
        if (t, m) in self.freed:
            self.after_free.append(("write", t, m))
        self.mailbox[t][m][slot][s][area][k] = value

    def read(self, t, m, slot, s, area, k):
        if (t, m) in self.freed:
            self.after_free.append(("read", t, m))
        return self.mailbox[t][m][slot][s][area][k]


def _rank(mesh: Mesh, r: int, out: dict, plan, credit: bool = True, flag_first: bool = False,
          free_on_grow: bool = False, remote_credit: bool = True):
    """Rank ``r``'s collectives as a generator: it yields before each atomic
    step, or a predicate that must hold before it goes on (a spin).
    Collective ``g`` is ``plan[g - 1]``: (kind, chunks, mailbox).
    ``free_on_grow`` frees a rank's earlier mailboxes when it makes a new
    one; ``remote_credit`` False skips the credit wait for remote peers."""
    world, slots = mesh.world, mesh.slots
    peers = [t for t in range(world) if t != r]

    def push(m, slot, e, k, area, value):
        """``value(t)`` into area ``area`` of every peer's region ``r`` (a
        remote peer's: this rank's out staging for it, its chunk
        description, then its flag of the slot), then the island peers'
        flags (or the flags first, where broken)."""
        for t in peers:
            if mesh.remote(r, t):
                yield
                mesh.out[r][t][m][slot][area][k] = value(t)
                yield
                mesh.odesc[r][t][slot][area][k] = m
                yield
                mesh.oflags[r][t][slot][area][k] = e
                continue
            if flag_first:
                yield
                mesh.flags[t][r][area][k] = e
            yield
            mesh.write(t, m, slot, r, area, k, value(t))
        if not flag_first:
            for t in peers:
                if not mesh.remote(r, t):
                    yield
                    mesh.flags[t][r][area][k] = e

    def arrived(q, slot, area, k, e):
        """Whether peer ``q``'s chunk ``k`` of epoch ``e`` is here: its flag
        (island) or its flag of the slot (remote)."""
        if mesh.remote(r, q):
            return mesh.iflags[r][q][slot][area][k] >= e
        return mesh.flags[r][q][area][k] >= e

    def receive(m, slot, e, k, q, area, got):
        """Chunk ``k`` of area ``area`` of region ``q`` of the own mailbox
        (across hosts: the in staging from ``q``) appended to ``got`` (its
        flag waited for by the caller)."""
        key = (r, m, slot, q, area, k)
        mesh.reading.setdefault(key, set()).add(r)
        yield
        got.append(mesh.read(r, m, slot, q, area, k))
        mesh.reading[key].discard(r)

    for g, (kind, chunks, m) in enumerate(plan, 1):
        if m >= mesh.made[r]:
            mesh.made[r] = m + 1
            if free_on_grow:
                mesh.freed.update((r, old) for old in range(m))
        yield
        e = mesh.epoch[r] + 1
        slot = e % slots
        rows = [[None] * world for _ in range(chunks)]
        # step by step, as one block of the kernel takes its chunks: push
        # chunk k, receive chunk k - 1 (a sum: its own slice added up and
        # its sums pushed), and a sum collects the peers' sums of chunk k - 2
        lag = 2 if kind == "sum" else 1
        for k in range(chunks + lag):
            if k < chunks:
                if k == 0 and credit:
                    for t in peers:
                        if remote_credit or not mesh.remote(r, t):
                            yield lambda t=t: mesh.acks[r][t] >= e - 2
                # a gather's chunk k for every peer; a sum's, peer t's slice
                yield from push(m, slot, e, k, 0, lambda t, k=k: (g, r, k) if kind == "gather" else (g, r, k, t))
            k1 = k - 1
            if 0 <= k1 < chunks and kind == "gather":
                for q in range(world):
                    if q == r:
                        rows[k1][q] = (g, r, k1)
                        continue
                    yield lambda q=q, k1=k1: arrived(q, slot, 0, k1, e)
                    got = []
                    yield from receive(m, slot, e, k1, q, 0, got)
                    rows[k1][q] = got[0]
            elif 0 <= k1 < chunks:
                for s in peers:
                    yield lambda s=s, k1=k1: arrived(s, slot, 0, k1, e)
                parts = []
                for q in range(world):
                    if q == r:
                        parts.append((g, r, k1, r))
                    else:
                        yield from receive(m, slot, e, k1, q, 0, parts)
                # the adds in global shard order, of every shard's part of the own slice
                total = ("sum", g, r, k1) if parts == [(g, q, k1, r) for q in range(world)] else ("bad", parts)
                rows[k1][r] = total
                yield from push(m, slot, e, k1, 1, lambda t, total=total: total)
            k2 = k - 2
            if 0 <= k2 < chunks and kind == "sum":
                for q in peers:
                    yield lambda q=q, k2=k2: arrived(q, slot, 1, k2, e)
                    got = []
                    yield from receive(m, slot, e, k2, q, 1, got)
                    rows[k2][q] = got[0]
        out[g, r] = rows
        # the last block: the epoch, then the acknowledgements (a remote
        # peer's into this rank's word for the wire)
        yield
        mesh.epoch[r] = e
        for t in peers:
            yield
            if mesh.remote(r, t):
                mesh.ack_out[r][t] = e
            else:
                mesh.acks[t][r] = e


def _run_start(mesh: Mesh, s: int, t: int, slot: int, area: int):
    """Where link s -> t's cursor of ``slot`` and ``area`` (a half of the
    flags: a chunk counts from the first) has a run up, as the proxy finds
    it: the cursor's epoch's next chunk raised, or a newer epoch's first
    chunk; (epoch, first chunk) or None."""
    e, k = mesh.cursor[s][t][slot][area]
    flags = mesh.oflags[s][t][slot][area]
    if k < CHUNKS and e and flags[k] == e:
        return e, k
    if flags[0] > e:
        return flags[0], 0
    return None


def _pending(mesh: Mesh, s: int, t: int, acks: bool, run_flags=None):
    """What link s -> t's proxy sends next: an acknowledgement not yet sent,
    else the run of the lowest epoch (in one epoch, the area not served
    last): from a cursor of a slot and area, its
    consecutive chunks of that epoch whose flags are up (``run_flags``:
    whether a chunk may join a run, given its flag and the run's epoch; a
    broken proxy's rule), else None."""
    if acks and mesh.ack_out[s][t] > mesh.ack_sent[s][t]:
        return ("ack", mesh.ack_out[s][t])
    best = None
    for slot in range(mesh.slots):
        for area in range(2):
            start = _run_start(mesh, s, t, slot, area)
            if start is None:
                continue
            # the lower epoch; in one epoch the area not served last
            if best is None or start[0] < best[1] or (start[0] == best[1] and area != mesh.last_area[s][t]):
                best = ("run", start[0], slot, area, start[1])
    if best is None:
        return None
    _, e, slot, area, k0 = best
    join = run_flags or (lambda f, e: f == e)
    flags = mesh.oflags[s][t][slot][area]
    ks = [k0]
    while ks[-1] + 1 < CHUNKS and join(flags[ks[-1] + 1], e):
        ks.append(ks[-1] + 1)
    return ("run", e, slot, area, ks)


def _send_link(mesh: Mesh, s: int, t: int, acks: bool = True, sockets: int = 1, run_flags=None):
    """Rank s's proxy, its link to t: each acknowledgement, and each run of
    raised chunks (read from the out staging of the generation each
    chunk's description names) as one message, onto the link's
    ``sockets`` channels in turn, one message a step (``acks`` False: no
    acknowledgement crosses the wire)."""
    turn = 0
    while True:
        yield lambda: _pending(mesh, s, t, acks, run_flags) is not None
        item = _pending(mesh, s, t, acks, run_flags)
        chan = mesh.chan[s][t][turn % sockets]
        turn += 1
        if item[0] == "ack":
            mesh.ack_sent[s][t] = item[1]
            chan.append(item)
            continue
        _, e, slot, area, ks = item
        chunks = []
        for k in ks:
            m = mesh.odesc[s][t][slot][area][k]
            chunks.append((k, m, mesh.out[s][t][m][slot][area][k]))
        chan.append(("run", slot, area, e, chunks))
        mesh.cursor[s][t][slot][area] = (e, ks[-1] + 1)
        mesh.last_area[s][t] = area


def _recv_link(mesh: Mesh, s: int, t: int, channel: int = 0, flag_first: bool = False,
               run_flags_first: bool = False):
    """Rank t's proxy, its link from s, one channel: each chunk of a run
    into t's in staging, then its flag of the slot (``flag_first``: each
    chunk's flag, then the chunk; ``run_flags_first``: every flag of the
    run, then the chunks); an acknowledgement into t's word of s's
    acknowledgements."""
    queue = mesh.chan[s][t][channel]
    while True:
        yield lambda: bool(queue)
        msg = queue.popleft()
        if msg[0] == "ack":
            mesh.acks[t][s] = max(mesh.acks[t][s], msg[1])
            continue
        _, slot, area, e, chunks = msg
        if run_flags_first:
            for k, _, _ in chunks:
                mesh.iflags[t][s][slot][area][k] = e
                yield
        for k, m, value in chunks:
            if flag_first:
                mesh.iflags[t][s][slot][area][k] = e
                yield
            mesh.write(t, m, slot, s, area, k, value)
            if not flag_first and not run_flags_first:
                yield
                mesh.iflags[t][s][slot][area][k] = e
            yield


def _run(world: int, schedule, plan, slots: int = 2, hosts=None, proxy_flag_first: bool = False,
         wire_acks: bool = True, sockets: int = 1, run_flags_first: bool = False, run_flags=None, **broken):
    """Every rank's collectives of ``plan``, interleaved by ``schedule`` (a
    rank index a step among the ranks that can step, then the first that
    can; with remote peers, the first rank or proxy link that can step from
    the drawn one on) with ``hosts`` a label a rank (one host by default),
    ``sockets`` channels a link. Returns (outputs, overwrites and touches
    of freed mailboxes, deadlocked)."""
    mesh, out = Mesh(world, slots, max(m for _, _, m in plan) + 1, hosts, sockets), {}
    actors = [_rank(mesh, r, out, plan, **broken) for r in range(world)]
    for a in range(world):
        for b in range(world):
            if a != b and mesh.remote(a, b):
                actors.append(_send_link(mesh, a, b, wire_acks, sockets, run_flags))
                for c in range(sockets):
                    actors.append(_recv_link(mesh, a, b, c, proxy_flag_first, run_flags_first))
    n = len(actors)
    pending = [None] * n
    done = [False] * n
    can = lambda r: not done[r] and (pending[r] is None or pending[r]())
    picks = iter(schedule)
    while not all(done[:world]):
        if n == world:
            ready = [r for r in range(n) if can(r)]
            r = ready[next(picks, 0) % len(ready)] if ready else None
        else:  # with the links' actors: the first that can step from a drawn one on
            start = next(picks, 0) % n
            r = next((i % n for i in range(start, start + n) if can(i % n)), None)
        if r is None:
            return out, mesh.overwrites + mesh.after_free, True
        try:
            pending[r] = next(actors[r])
        except StopIteration:
            done[r] = True
    return out, mesh.overwrites + mesh.after_free, False


def _wrong(world: int, out: dict, plan) -> list:
    """The (collective, rank) whose output is not, chunk by chunk, that
    collective's blocks in rank order (a gather) or every slice's sum of
    every shard's part in global order (a sum)."""
    def want(g, kind, chunks):
        if kind == "gather":
            return [[(g, q, k) for q in range(world)] for k in range(chunks)]
        return [[("sum", g, q, k) for q in range(world)] for k in range(chunks)]

    return [(g, r) for g, (kind, chunks, _) in enumerate(plan, 1) for r in range(world)
            if out.get((g, r)) != want(g, kind, chunks)]


_PLAN = st.lists(st.tuples(st.sampled_from(["gather", "sum"]), st.integers(0, CHUNKS), st.integers(0, 2)),
                 min_size=GATHERS, max_size=GATHERS)


@pytest.mark.parametrize("world", [2, 4])
@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(schedule=st.lists(st.integers(0, 7), max_size=600), plan=_PLAN)
def test_every_rank_gets_every_epochs_blocks(world, schedule, plan):
    """Pushes, a flag a (sender, chunk), two slots and the credits, whichever
    kind, chunks and mailbox each collective has: every interleaving
    delivers each collective's blocks in rank order to every rank, no
    region is written while a peer reads it, no freed mailbox is touched,
    and no rank waits forever."""
    out, overwrites, deadlocked = _run(world, schedule, plan)
    assert not deadlocked
    assert overwrites == []
    assert _wrong(world, out, plan) == []


# collectives that expose each fault: an empty collective lets a rank run
# two ahead of a slow peer (which only the credit stops)
_FULL = [("gather", 2, 0), ("sum", 2, 0), ("gather", 1, 0), ("sum", 2, 0), ("gather", 2, 0)]
_EMPTY = [("gather", 2, 0), ("gather", 0, 0), ("gather", 2, 0), ("sum", 0, 0), ("sum", 2, 0)]
_GROW = [("gather", 2, 0), ("sum", 2, 1), ("gather", 2, 0), ("sum", 2, 1), ("gather", 2, 0)]


@pytest.mark.parametrize("broken,plan", [(dict(credit=False), _EMPTY), (dict(slots=1), _FULL),
                                         (dict(flag_first=True), _FULL), (dict(free_on_grow=True), _GROW)],
                         ids=["no_credit", "one_slot", "flag_before_data", "free_on_grow"])
def test_the_model_catches_a_broken_protocol(broken, plan):
    """Without the credit, a rank past an empty collective rewrites a slot
    a slower peer still reads; with one slot a rank overwrites a block a
    slower peer still reads; with the flag before the data a rank reads a
    block before it is written; freeing the earlier mailboxes when a larger
    one is made, a graph captured on one touches freed memory when it
    replays. Some of 300 random interleavings of 2 ranks show it, and the
    whole protocol passes the same interleavings."""
    rng = random.Random(0)
    caught = whole = 0
    for _ in range(300):
        schedule = [rng.randrange(8) for _ in range(600)]
        out, overwrites, deadlocked = _run(2, schedule, plan, **broken)
        caught += bool(overwrites or _wrong(2, out, plan) or deadlocked)
        out, overwrites, deadlocked = _run(2, schedule, plan)
        whole += bool(overwrites or _wrong(2, out, plan) or deadlocked)
    assert caught > 0 and whole == 0


def _check_across_hosts(data, worlds, max_schedule, **wire):
    world = data.draw(worlds, label="world")
    hosts = data.draw(st.lists(st.integers(0, 3), min_size=world, max_size=world), label="hosts")
    plan = data.draw(_PLAN, label="plan")
    schedule = data.draw(st.lists(st.integers(0, 63), max_size=max_schedule), label="schedule")
    out, overwrites, deadlocked = _run(world, schedule, plan, hosts=hosts, **wire)
    assert not deadlocked
    assert overwrites == []
    assert _wrong(world, out, plan) == []


@settings(max_examples=200, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_across_hosts_every_rank_gets_every_epochs_blocks(data):
    """2-4 ranks on 1-4 hosts: island peers through the mailbox, remote ones
    through the out staging, the proxies' ordered channels and the in
    staging, flags a slot, acknowledgements over the wire; every
    interleaving delivers each collective's blocks in rank order (a sum's
    in global shard order) to every rank, no staging or region is written
    while a peer reads it, and no rank or proxy waits forever."""
    _check_across_hosts(data, st.integers(2, 4), 1500)


@settings(max_examples=25, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_across_hosts_many_ranks(data):
    """The same with 5-16 ranks on 1-4 hosts (fewer interleavings: each
    takes thousands of steps)."""
    _check_across_hosts(data, st.sampled_from([5, 8, 16]), 4000)


@settings(max_examples=100, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_across_hosts_acks_may_overtake_runs(data):
    """Two channels a link, as two sockets a peer would give, the sender's
    messages on them in turn, so an acknowledgement may overtake a run of
    its epoch: 2-4 ranks on 1-4 hosts still get every collective's blocks,
    no staging is written while read, and nothing waits forever. An
    acknowledgement of epoch e leaves a rank only after every chunk of e
    sent to it landed, and the credit it gives (to rewrite the slot of e
    at e + 2) needs nothing of what it overtakes: the proxy needs no order
    between its runs and its acknowledgements."""
    _check_across_hosts(data, st.integers(2, 4), 1500, sockets=2)


@pytest.mark.parametrize("broken,plan", [(dict(proxy_flag_first=True), _FULL), (dict(wire_acks=False), _FULL),
                                         (dict(remote_credit=False), _EMPTY), (dict(run_flags_first=True), _FULL),
                                         (dict(run_flags=lambda f, e: f != 0), _FULL)],
                         ids=["proxy_flag_before_chunk", "no_ack_over_the_wire", "slot_reuse_before_remote_ack",
                              "run_flags_before_bytes", "run_joins_another_epoch"])
def test_the_model_catches_a_broken_cross_host_protocol(broken, plan):
    """Two ranks on two hosts. A proxy that raises a chunk's flag before it
    lands the chunk lets the kernel read the slot's last epoch; a wire that
    carries no acknowledgement leaves the credit wait forever; a rank that
    rewrites a slot before the remote acknowledgement -- possible past an
    empty collective -- has its proxy send the new chunk under the old
    epoch's flag; a receiving proxy that raises every flag of a run before
    it lands the run's bytes lets the kernel read chunks of the slot's last
    epoch; a sender whose run takes in any raised chunk after its first
    (a flag up from another epoch, not the run's) sends an older epoch's
    bytes under the run's epoch. Some of 300 random interleavings show it,
    and the whole protocol passes the same interleavings."""
    rng = random.Random(1)
    caught = whole = 0
    for _ in range(300):
        schedule = [rng.randrange(64) for _ in range(1500)]
        out, overwrites, deadlocked = _run(2, schedule, plan, hosts=[0, 1], **broken)
        caught += bool(overwrites or _wrong(2, out, plan) or deadlocked)
        out, overwrites, deadlocked = _run(2, schedule, plan, hosts=[0, 1])
        whole += bool(overwrites or _wrong(2, out, plan) or deadlocked)
    assert caught > 0 and whole == 0
