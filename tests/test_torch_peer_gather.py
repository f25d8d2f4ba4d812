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

``hypothesis`` draws the interleavings of 2 and 4 ranks over several
collectives, and each collective's kind, chunks (0 to 2) and mailbox. Every
rank's output of every collective must be, chunk by chunk, that collective's
blocks in rank order (a gather) or each slice's sum of every shard's part
added in global shard order (a sum), no
rank may write a region while a peer is reading it, no rank may touch a
freed mailbox, and every rank must end (no deadlock). The same model
without the credit wait, with one slot, with the flag stored before the
data, or freeing a rank's earlier mailboxes when it makes a new one, must
fail, which shows that the checks can fail.
"""

import random

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

GATHERS = 5
CHUNKS = 2


class Mesh:
    """The ranks' device memory: mailboxes, flags, acknowledgements,
    epoch counters."""

    def __init__(self, world: int, slots: int, mailboxes: int):
        self.world, self.slots = world, slots
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
          free_on_grow: bool = False):
    """Rank ``r``'s collectives as a generator: it yields before each atomic
    step, or a predicate that must hold before it goes on (a spin).
    Collective ``g`` is ``plan[g - 1]``: (kind, chunks, mailbox).
    ``free_on_grow`` frees a rank's earlier mailboxes when it makes a new
    one."""
    world, slots = mesh.world, mesh.slots
    peers = [t for t in range(world) if t != r]

    def push(m, slot, e, k, area, value):
        """``value(t)`` into area ``area`` of every peer's region ``r``, then
        the flags (or the flags first, where broken)."""
        for t in peers:
            if flag_first:
                yield
                mesh.flags[t][r][area][k] = e
            yield
            mesh.write(t, m, slot, r, area, k, value(t))
        if not flag_first:
            for t in peers:
                yield
                mesh.flags[t][r][area][k] = e

    def receive(m, slot, e, k, q, area, got):
        """Chunk ``k`` of area ``area`` of region ``q`` of the own mailbox
        appended to ``got`` (its flag waited for by the caller)."""
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
                        yield lambda t=t: mesh.acks[r][t] >= e - 2
                # a gather's chunk k for every peer; a sum's, peer t's slice
                yield from push(m, slot, e, k, 0, lambda t, k=k: (g, r, k) if kind == "gather" else (g, r, k, t))
            k1 = k - 1
            if 0 <= k1 < chunks and kind == "gather":
                for q in range(world):
                    if q == r:
                        rows[k1][q] = (g, r, k1)
                        continue
                    yield lambda q=q, k1=k1: mesh.flags[r][q][0][k1] >= e
                    got = []
                    yield from receive(m, slot, e, k1, q, 0, got)
                    rows[k1][q] = got[0]
            elif 0 <= k1 < chunks:
                for s in peers:
                    yield lambda s=s, k1=k1: mesh.flags[r][s][0][k1] >= e
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
                    yield lambda q=q, k2=k2: mesh.flags[r][q][1][k2] >= e
                    got = []
                    yield from receive(m, slot, e, k2, q, 1, got)
                    rows[k2][q] = got[0]
        out[g, r] = rows
        # the last block: the epoch, then the acknowledgements
        yield
        mesh.epoch[r] = e
        for t in peers:
            yield
            mesh.acks[t][r] = e


def _run(world: int, schedule, plan, slots: int = 2, **broken):
    """Every rank's collectives of ``plan``, interleaved by ``schedule`` (a
    rank index a step among the ranks that can step, then the first that
    can). Returns (outputs, overwrites and touches of freed mailboxes,
    deadlocked)."""
    mesh, out = Mesh(world, slots, max(m for _, _, m in plan) + 1), {}
    gens = [_rank(mesh, r, out, plan, **broken) for r in range(world)]
    pending = [None] * world
    done = [False] * world
    picks = iter(schedule)
    while not all(done):
        ready = [r for r in range(world) if not done[r] and (pending[r] is None or pending[r]())]
        if not ready:
            return out, mesh.overwrites + mesh.after_free, True
        r = ready[next(picks, 0) % len(ready)]
        try:
            pending[r] = next(gens[r])
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
