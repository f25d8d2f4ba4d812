"""The protocol of the mesh's gather over peer memory
(``loam_tpu_torch/ops/csrc/peer_gather.cu``), as a pure-Python model.

The kernels run only on a card; what can be checked here is their protocol.
Each rank's program is the three kernels' steps, one atomic step at a time:

  * put: read the epoch counter, ``e = epoch + 1``, and write its block into
    its own mailbox's slot ``e % 2``, a chunk a step;
  * signal: store ``e`` into every rank's flag word for this rank, a rank a
    step, then wait until every flag word of its own is ``>= e``, then store
    the epoch counter;
  * pull: read every peer's slot ``e % 2``, a chunk a step, in rank order,
    and its own block from its input.

A mesh makes a larger mailbox where a gather outgrows it and keeps the
earlier ones: a graph captured on an earlier mailbox replays it after a
later one was made. Each gather names the mailbox it uses (the same on
every rank: they grow at the same gather and capture the same programs).

``hypothesis`` draws the interleavings of 2 and 4 ranks over several
gathers, and each gather's mailbox. Every rank's output of every gather
must equal that gather's inputs in rank order, no rank may write a slot
while a peer is reading it, no rank may touch a freed mailbox, and every
rank must end (no deadlock). The same model with one slot, without the
wait, or freeing a rank's earlier mailboxes when it makes a new one, must
fail, which shows that the checks can fail.
"""

import random

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

GATHERS = 5
CHUNKS = 2


class Mesh:
    """The ranks' device memory: mailboxes, flags, epoch counters."""

    def __init__(self, world: int, slots: int, mailboxes: int):
        self.world, self.slots = world, slots
        # mailbox[r][m][slot]: rank r's mailbox m
        self.mailbox = [[[[None] * CHUNKS for _ in range(slots)] for _ in range(mailboxes)]
                        for _ in range(world)]
        self.flags = [[0] * world for _ in range(world)]  # flags[t][r]: what rank r published to t
        self.epoch = [0] * world
        self.made = [0] * world  # mailboxes each rank made
        self.freed = set()  # (rank, mailbox)
        self.reading = {}  # (rank, mailbox, slot) -> the readers inside it
        self.overwrites, self.after_free = [], []

    def write(self, r, m, slot, c, value):
        if self.reading.get((r, m, slot)):
            self.overwrites.append((r, m, slot, sorted(self.reading[(r, m, slot)])))
        if (r, m) in self.freed:
            self.after_free.append(("write", r, m))
        self.mailbox[r][m][slot][c] = value

    def read(self, q, m, slot, c):
        if (q, m) in self.freed:
            self.after_free.append(("read", q, m))
        return self.mailbox[q][m][slot][c]


def _rank(mesh: Mesh, r: int, out: dict, boxes, wait: bool = True, free_on_grow: bool = False):
    """Rank ``r``'s gathers as a generator: it yields before each atomic
    step, or a predicate that must hold before it goes on (a spin). Gather
    ``g`` uses mailbox ``boxes[g - 1]``; ``free_on_grow`` frees a rank's
    earlier mailboxes when it makes a new one."""
    world, slots = mesh.world, mesh.slots
    for g in range(1, GATHERS + 1):
        m = boxes[g - 1]
        if m >= mesh.made[r]:
            mesh.made[r] = m + 1
            if free_on_grow:
                mesh.freed.update((r, old) for old in range(m))
        # put
        yield
        e = mesh.epoch[r] + 1
        slot = e % slots
        for c in range(CHUNKS):
            yield
            mesh.write(r, m, slot, c, (g, r, c))
        # signal
        for t in range(world):
            yield
            mesh.flags[t][r] = e
        if wait:
            for t in range(world):
                yield lambda t=t: mesh.flags[r][t] >= e
        yield
        mesh.epoch[r] = e
        # pull
        yield
        e = mesh.epoch[r]
        got = []
        for q in range(world):
            key = (q, m, e % slots)
            mesh.reading.setdefault(key, set()).add(r)
            for c in range(CHUNKS):
                yield
                got.append((g, r, c) if q == r else mesh.read(q, m, e % slots, c))
            mesh.reading[key].discard(r)
        out[g, r] = got


def _run(world: int, schedule, boxes=(0,) * GATHERS, slots: int = 2, wait: bool = True,
         free_on_grow: bool = False):
    """Every rank's gathers on the mailboxes ``boxes``, interleaved by
    ``schedule`` (a rank index a step among the ranks that can step, then
    the first that can). Returns (outputs, overwrites and touches of freed
    mailboxes, deadlocked)."""
    mesh, out = Mesh(world, slots, max(boxes) + 1), {}
    gens = [_rank(mesh, r, out, boxes, wait, free_on_grow) for r in range(world)]
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


def _wrong(world: int, out: dict) -> list:
    """The (gather, rank) whose output is not that gather's blocks in rank
    order."""
    want = lambda g: [(g, q, c) for q in range(world) for c in range(CHUNKS)]
    return [(g, r) for g in range(1, GATHERS + 1) for r in range(world) if out.get((g, r)) != want(g)]


@pytest.mark.parametrize("world", [2, 4])
@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(schedule=st.lists(st.integers(0, 7), max_size=600),
       boxes=st.lists(st.integers(0, 2), min_size=GATHERS, max_size=GATHERS))
def test_every_rank_gets_every_epochs_blocks(world, schedule, boxes):
    """Two slots and one barrier a gather, whichever mailbox each gather
    uses: every interleaving delivers each gather's blocks in rank order to
    every rank, no slot is written while a peer reads it, no freed mailbox
    is touched, and no rank waits forever."""
    out, overwrites, deadlocked = _run(world, schedule, boxes)
    assert not deadlocked
    assert overwrites == []
    assert _wrong(world, out) == []


@pytest.mark.parametrize("broken", [dict(slots=1), dict(wait=False),
                                    dict(boxes=(0, 1, 0, 1, 0), free_on_grow=True)],
                         ids=["one_slot", "no_wait", "free_on_grow"])
def test_the_model_catches_a_broken_protocol(broken):
    """With one slot a rank overwrites a block a slower peer still reads;
    without the wait a rank reads a block before it is written; freeing the
    earlier mailboxes when a larger one is made, a graph captured on one
    touches freed memory when it replays. Some of 300 random interleavings
    of 2 ranks show it."""
    rng = random.Random(0)
    caught = 0
    for _ in range(300):
        schedule = [rng.randrange(8) for _ in range(600)]
        out, overwrites, deadlocked = _run(2, schedule, **broken)
        caught += bool(overwrites or _wrong(2, out) or deadlocked)
    assert caught > 0
