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
there. The staging is one for the mesh, whatever its mailbox, and holds a
window of chunks: on a mesh with remote peers a collective goes in pieces
of at most ``window`` chunks, each an epoch of its own (a slot, a credit,
an acknowledgement), its remote chunks at their places within the piece
and its island chunks at their places in the whole payload. The sender's
proxy, an actor of its own a link, sends each
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
2-16 ranks on 1-4 hosts, 12 ranks, 24 ranks on 3 hosts, a window of one
chunk (every chunk its own piece) or of the whole collective, and two
channels a link on which an acknowledgement may overtake a run (which is
safe); the model where a proxy raises a flag before it lands the chunk or
a run's flags before its bytes, where a run takes in a chunk of another
epoch, where no acknowledgement crosses the wire, where a rank reuses a
slot before the remote acknowledgement (no credit wait for a remote peer),
or where a collective's pieces share one epoch must fail on some
interleavings that the whole protocol passes, at 2, 12 and 24 ranks.
"""

import functools
import random
from collections import deque

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

GATHERS = 5
CHUNKS = 2


class Mesh:
    """The ranks' device memory: mailboxes, flags, acknowledgements,
    epoch counters; across hosts the staging (a window of chunks)."""

    def __init__(self, world: int, slots: int, mailboxes: int, hosts=None, sockets: int = 1,
                 window: int = CHUNKS):
        self.world, self.slots, self.window = world, slots, window
        self.hosts = hosts or [0] * world
        # across hosts: out staging out[s][t][slot][area][kl] (at s, for t;
        # kl a chunk's place in its piece), its flags a slot (at s), the in
        # staging's flags a slot iflags[t][s][slot][area][kl] (at t; the in
        # staging is memory ("in", t, s, slot, area, kl)), the
        # acknowledgement for the wire ack_out[s][t], a link's channels
        # chan[s][t][c] and its proxy's cursors cursor[s][t][slot][area] =
        # (epoch, next chunk)
        per = lambda f: [[f() for _ in range(world)] for _ in range(world)]
        area_k = lambda: [[0] * CHUNKS for _ in range(2)]
        self.out = per(lambda: [[[None] * CHUNKS for _ in range(2)] for _ in range(slots)])
        self.oflags = per(lambda: [area_k() for _ in range(slots)])
        self.iflags = per(lambda: [area_k() for _ in range(slots)])
        self.cursor = per(lambda: [[(0, CHUNKS)] * 2 for _ in range(slots)])
        self.last_area = per(lambda: 1)
        self.ack_out, self.ack_sent = per(int), per(int)
        # the links whose proxy may have something to send (its rank raised
        # a flag or an acknowledgement, or it sent) and the channels that
        # hold a message: the scheduler looks at the others' waits only
        # when these say (a speed-up, the same steps)
        self.dirty = {(a, b) for a in range(world) for b in range(world) if a != b}
        self.sendable, self.busy = set(), set()
        self.chan = per(lambda: [deque() for _ in range(sockets)])
        # memory[("box", t, m, slot, s, area, k)]: chunk k of region s
        # (sender s) of rank t's mailbox m; area 0 a gather's payload or a
        # sum's slices, area 1 a sum's sums; memory[("in", t, s, slot, area,
        # kl)]: the in staging
        self.memory = {}
        # flags[t][s][phase][k], at t
        self.flags = [[[[0] * CHUNKS for _ in range(2)] for _ in range(world)] for _ in range(world)]
        self.acks = [[0] * world for _ in range(world)]  # acks[s][t], at s: what rank t acknowledged
        self.epoch = [0] * world
        self.made = [0] * world  # mailboxes each rank made
        self.freed = set()  # (rank, mailbox)
        self.reading = {}  # a memory key -> the readers inside it
        self.overwrites, self.after_free = [], []

    def remote(self, a: int, b: int) -> bool:
        return self.hosts[a] != self.hosts[b]

    def _freed(self, key, what):
        if key[0] == "box" and (key[1], key[2]) in self.freed:
            self.after_free.append((what, key[1], key[2]))

    def write(self, key, value):
        if self.reading.get(key):
            self.overwrites.append(key)
        self._freed(key, "write")
        self.memory[key] = value

    def read(self, key):
        self._freed(key, "read")
        return self.memory.get(key)


def _rank(mesh: Mesh, r: int, out: dict, plan, credit: bool = True, flag_first: bool = False,
          free_on_grow: bool = False, remote_credit: bool = True, one_epoch: bool = False):
    """Rank ``r``'s collectives as a generator: it yields before each atomic
    step, or a predicate that must hold before it goes on (a spin).
    Collective ``g`` is ``plan[g - 1]``: (kind, chunks, mailbox); on a mesh
    with remote peers it runs in pieces of ``mesh.window`` chunks, an epoch
    each. ``free_on_grow`` frees a rank's earlier mailboxes when it makes a
    new one; ``remote_credit`` False skips the credit wait for remote peers;
    ``one_epoch`` runs a collective's pieces in one epoch (the staging's
    window reused within it)."""
    world, slots = mesh.world, mesh.slots
    peers = [t for t in range(world) if t != r]
    pieces_of = mesh.window if any(mesh.remote(r, t) for t in peers) else CHUNKS

    def place(t, m, slot, s, area, k, k0):
        """Where chunk ``k`` of sender ``s`` lands at rank ``t``: its
        mailbox's region ``s`` (island), or the in staging from ``s`` at
        its place in the piece (remote)."""
        if mesh.remote(s, t):
            return ("in", t, s, slot, area, k - k0)
        return ("box", t, m, slot, s, area, k)

    def push(m, slot, e, k, k0, area, value):
        """``value(t)`` into area ``area`` of every peer's region ``r`` (a
        remote peer's: this rank's out staging for it at the chunk's place
        in the piece, then its flag of the slot), then the island peers'
        flags (or the flags first, where broken)."""
        for t in peers:
            if mesh.remote(r, t):
                yield
                mesh.out[r][t][slot][area][k - k0] = value(t)
                yield
                mesh.oflags[r][t][slot][area][k - k0] = e
                mesh.dirty.add((r, t))
                continue
            if flag_first:
                yield
                mesh.flags[t][r][area][k] = e
            yield
            mesh.write(place(t, m, slot, r, area, k, k0), value(t))
        if not flag_first:
            for t in peers:
                if not mesh.remote(r, t):
                    yield
                    mesh.flags[t][r][area][k] = e

    def arrived(q, slot, area, k, k0, e):
        """Whether peer ``q``'s chunk ``k`` of epoch ``e`` is here: its flag
        (island) or its flag of the slot (remote)."""
        if mesh.remote(r, q):
            return mesh.iflags[r][q][slot][area][k - k0] >= e
        return mesh.flags[r][q][area][k] >= e

    def receive(m, slot, k, k0, q, area, got):
        """Chunk ``k`` of area ``area`` of region ``q`` of the own mailbox
        (across hosts: the in staging from ``q``) appended to ``got`` (its
        flag waited for by the caller)."""
        key = place(r, m, slot, q, area, k, k0)
        mesh.reading.setdefault(key, set()).add(r)
        yield
        got.append(mesh.read(key))
        mesh.reading[key].discard(r)

    def finish(e):
        """The last block: the epoch, then the acknowledgements (a remote
        peer's into this rank's word for the wire)."""
        yield
        mesh.epoch[r] = e
        for t in peers:
            yield
            if mesh.remote(r, t):
                mesh.ack_out[r][t] = e
                mesh.dirty.add((r, t))
            else:
                mesh.acks[t][r] = e

    for g, (kind, chunks, m) in enumerate(plan, 1):
        if m >= mesh.made[r]:
            mesh.made[r] = m + 1
            if free_on_grow:
                mesh.freed.update((r, old) for old in range(m))
        rows = [[None] * world for _ in range(chunks)]
        lag = 2 if kind == "sum" else 1
        pieces = max(1, -(-chunks // pieces_of))
        for p in range(pieces):
            if p == 0 or not one_epoch:
                yield
                e = mesh.epoch[r] + 1
                slot = e % slots
            k0, k1 = p * pieces_of, min(chunks, (p + 1) * pieces_of)
            # step by step, as one block of the kernel takes its chunks: push
            # chunk k, receive chunk k - 1 (a sum: its own slice added up and
            # its sums pushed), and a sum collects the peers' sums of chunk k - 2
            for k in range(k0, k1 + lag):
                if k < k1:
                    if k == k0 and credit and (p == 0 or not one_epoch):
                        for t in peers:
                            if remote_credit or not mesh.remote(r, t):
                                yield lambda t=t: mesh.acks[r][t] >= e - 2
                    # a gather's chunk k for every peer; a sum's, peer t's slice
                    yield from push(m, slot, e, k, k0, 0,
                                    lambda t, k=k: (g, r, k) if kind == "gather" else (g, r, k, t))
                ka = k - 1
                if k0 <= ka < k1 and kind == "gather":
                    for q in range(world):
                        if q == r:
                            rows[ka][q] = (g, r, ka)
                            continue
                        yield lambda q=q, ka=ka: arrived(q, slot, 0, ka, k0, e)
                        got = []
                        yield from receive(m, slot, ka, k0, q, 0, got)
                        rows[ka][q] = got[0]
                elif k0 <= ka < k1:
                    for s in peers:
                        yield lambda s=s, ka=ka: arrived(s, slot, 0, ka, k0, e)
                    parts = []
                    for q in range(world):
                        if q == r:
                            parts.append((g, r, ka, r))
                        else:
                            yield from receive(m, slot, ka, k0, q, 0, parts)
                    # the adds in global shard order, of every shard's part of the own slice
                    total = ("sum", g, r, ka) if parts == [(g, q, ka, r) for q in range(world)] else ("bad", parts)
                    rows[ka][r] = total
                    yield from push(m, slot, e, ka, k0, 1, lambda t, total=total: total)
                kb = k - 2
                if k0 <= kb < k1 and kind == "sum":
                    for q in peers:
                        yield lambda q=q, kb=kb: arrived(q, slot, 1, kb, k0, e)
                        got = []
                        yield from receive(m, slot, kb, k0, q, 1, got)
                        rows[kb][q] = got[0]
            # every block ends the piece before any starts the next: the
            # piece's last block stores its epoch (one_epoch: the collective's)
            if p == pieces - 1 or not one_epoch:
                yield from finish(e)
        out[g, r] = rows


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
    raised chunks (read from the out staging) as one message, onto the link's
    ``sockets`` channels in turn, one message a step (``acks`` False: no
    acknowledgement crosses the wire)."""
    turn = 0

    def ready():
        # once something is up to send it stays so until this proxy sends
        # (flags and acknowledgements only grow)
        if (s, t) in mesh.dirty and (s, t) not in mesh.sendable:
            if _pending(mesh, s, t, acks, run_flags) is None:
                mesh.dirty.discard((s, t))
            else:
                mesh.sendable.add((s, t))
        return (s, t) in mesh.sendable

    while True:
        yield ready
        mesh.sendable.discard((s, t))
        item = _pending(mesh, s, t, acks, run_flags)
        mesh.busy.add((s, t, turn % sockets))
        chan = mesh.chan[s][t][turn % sockets]
        turn += 1
        if item[0] == "ack":
            mesh.ack_sent[s][t] = item[1]
            chan.append(item)
            continue
        _, e, slot, area, ks = item
        chan.append(("run", slot, area, e, [(k, mesh.out[s][t][slot][area][k]) for k in ks]))
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
        if not queue:
            mesh.busy.discard((s, t, channel))
        if msg[0] == "ack":
            mesh.acks[t][s] = max(mesh.acks[t][s], msg[1])
            continue
        _, slot, area, e, chunks = msg
        if run_flags_first:
            for k, _ in chunks:
                mesh.iflags[t][s][slot][area][k] = e
                yield
        for k, value in chunks:
            if flag_first:
                mesh.iflags[t][s][slot][area][k] = e
                yield
            mesh.write(("in", t, s, slot, area, k), value)
            if not flag_first and not run_flags_first:
                yield
                mesh.iflags[t][s][slot][area][k] = e
            yield


def _run(world: int, schedule, plan, slots: int = 2, hosts=None, proxy_flag_first: bool = False,
         wire_acks: bool = True, sockets: int = 1, run_flags_first: bool = False, run_flags=None,
         window: int = CHUNKS, **broken):
    """Every rank's collectives of ``plan``, interleaved by ``schedule`` (a
    rank index a step among the ranks that can step, then the first that
    can; with remote peers, the first rank or proxy link that can step from
    the drawn one on) with ``hosts`` a label a rank (one host by default),
    ``sockets`` channels a link, a staging of ``window`` chunks. Returns
    (outputs, overwrites and touches of freed mailboxes, deadlocked)."""
    mesh, out = Mesh(world, slots, max(m for _, _, m in plan) + 1, hosts, sockets, window), {}
    actors = [_rank(mesh, r, out, plan, **broken) for r in range(world)]
    sender, receiver = {}, {}  # a link's actor, a channel's
    for a in range(world):
        for b in range(world):
            if a != b and mesh.remote(a, b):
                sender[a, b] = len(actors)
                actors.append(_send_link(mesh, a, b, wire_acks, sockets, run_flags))
                for c in range(sockets):
                    receiver[a, b, c] = len(actors)
                    actors.append(_recv_link(mesh, a, b, c, proxy_flag_first, run_flags_first))
    n = len(actors)
    pending = [None] * n
    done = [False] * n
    free = set(range(n))  # the actors not done and not waiting
    can = lambda r: not done[r] and (pending[r] is None or pending[r]())
    picks = iter(schedule)
    while not all(done[:world]):
        if n == world:
            ready = [r for r in range(n) if can(r)]
            r = ready[next(picks, 0) % len(ready)] if ready else None
        else:  # with the links' actors: the first that can step from a drawn one on
            start = next(picks, 0) % n
            # those that can: the free ones, the ranks whose wait holds, the
            # senders of links that may send, the receivers of channels that
            # hold a message (every other waiting proxy waits on)
            ready = list(free) + [i for i in range(world) if i not in free and can(i)]
            ready += [sender[k] for k in list(mesh.dirty) if k in sender and sender[k] not in free and
                      can(sender[k])]
            ready += [receiver[k] for k in mesh.busy if receiver[k] not in free]
            r = min(ready, key=lambda i: (i - start) % n) if ready else None
        if r is None:
            return out, mesh.overwrites + mesh.after_free, True
        try:
            pending[r] = next(actors[r])
        except StopIteration:
            done[r] = True
        if pending[r] is None and not done[r]:
            free.add(r)
        else:
            free.discard(r)
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
    if world == 24:  # three hosts of eight ranks
        hosts = [r // 8 for r in range(world)]
    else:
        hosts = data.draw(st.lists(st.integers(0, 3), min_size=world, max_size=world), label="hosts")
    plan = data.draw(_PLAN, label="plan")
    window = data.draw(st.sampled_from([1, CHUNKS]), label="window")
    schedule = data.draw(st.lists(st.integers(0, 63), max_size=max_schedule), label="schedule")
    out, overwrites, deadlocked = _run(world, schedule, plan, hosts=hosts, window=window, **wire)
    assert not deadlocked
    assert overwrites == []
    assert _wrong(world, out, plan) == []


@settings(max_examples=200, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_across_hosts_every_rank_gets_every_epochs_blocks(data):
    """2-4 ranks on 1-4 hosts: island peers through the mailbox, remote ones
    through the out staging, the proxies' ordered channels and the in
    staging, flags a slot, acknowledgements over the wire, a collective in
    pieces of the staging's window of one chunk or whole; every
    interleaving delivers each collective's blocks in rank order (a sum's
    in global shard order) to every rank, no staging or region is written
    while a peer reads it, and no rank or proxy waits forever."""
    _check_across_hosts(data, st.integers(2, 4), 1500)


@settings(max_examples=25, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_across_hosts_many_ranks(data):
    """The same with 5-16 ranks on 1-4 hosts, 12 ranks (not a power of
    two) and 24 ranks on 3 hosts of 8 (fewer interleavings: each takes
    thousands of steps)."""
    _check_across_hosts(data, st.sampled_from([5, 8, 12, 16, 24]), 4000)


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


_BROKEN_WIRE = [(dict(proxy_flag_first=True), _FULL), (dict(wire_acks=False), _FULL),
                (dict(remote_credit=False), _EMPTY), (dict(run_flags_first=True), _FULL),
                (dict(run_flags=lambda f, e: f != 0), _FULL), (dict(one_epoch=True, window=1), _FULL)]
_BROKEN_WIRE_IDS = ["proxy_flag_before_chunk", "no_ack_over_the_wire", "slot_reuse_before_remote_ack",
                    "run_flags_before_bytes", "run_joins_another_epoch", "pieces_in_one_epoch"]


@pytest.mark.parametrize("broken,plan", _BROKEN_WIRE, ids=_BROKEN_WIRE_IDS)
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
    bytes under the run's epoch; a collective whose pieces share one epoch
    rewrites the staging's window while the proxy or the peer still reads
    the piece before. Some of 300 random interleavings show it, and the
    whole protocol passes the same interleavings."""
    _caught(2, [0, 1], broken, plan, 300, 1500)


@functools.lru_cache(maxsize=None)
def _whole_fails(world, hosts, plan, window, schedule) -> bool:
    """Whether the whole protocol fails on this interleaving (a wrong
    output, an overwrite, a deadlock); kept, since the broken variants of
    a plan share their interleavings."""
    out, overwrites, deadlocked = _run(world, schedule, list(plan), hosts=list(hosts), window=window)
    return bool(overwrites or _wrong(world, out, plan) or deadlocked)


def _caught(world, hosts, broken, plan, tries, steps, seed=1):
    """Of ``tries`` random interleavings of ``steps`` picks, some break the
    ``broken`` model (a wrong output, an overwrite, a deadlock) and none
    the whole protocol at the same window."""
    rng = random.Random(seed)
    caught = whole = 0
    window = broken.get("window", CHUNKS)
    for _ in range(tries):
        schedule = [rng.randrange(64 * world) for _ in range(steps)]
        out, overwrites, deadlocked = _run(world, schedule, plan, hosts=hosts, **broken)
        caught += bool(overwrites or _wrong(world, out, plan) or deadlocked)
        whole += _whole_fails(world, tuple(hosts), tuple(plan), window, tuple(schedule))
    assert caught > 0 and whole == 0


@pytest.mark.parametrize("broken,plan", _BROKEN_WIRE, ids=_BROKEN_WIRE_IDS)
@pytest.mark.parametrize("world", [12, 24])
def test_the_model_catches_a_broken_cross_host_protocol_many_ranks(world, broken, plan):
    """The same faults at 12 ranks on 3 hosts of 4 and 24 on 3 hosts of 8:
    some of a few random interleavings show each, and the whole protocol
    passes them."""
    _caught(world, [r // (world // 3) for r in range(world)], broken, plan, 3 if world < 24 else 1, 40000,
            seed=world)
