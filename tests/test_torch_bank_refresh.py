"""Port parity for the async device-bank refresh: enumerated W/R/S/A (and C
with IVF) schedules through the reference's store and the port's from one
script, plus the cases of tests/test_bank_async.py by name (on the port's
store, CPU tensors: the plain versions of the kernels).

The schedule runner is the port's own copy of the reference's
tests/harness_concurrency.py, run on both packages. One step per token:

  * ``W``: the writer applies the next scripted mutation (add / upgrade /
    delete);
  * ``R``: the refresher advances one epoch phase (begin, apply, flip);
  * ``S``: a scan ``search_batch(impl=...)`` with the scenario's
    freshness; a scan whose policy must block first completes the epoch in
    flight, as the epoch lock makes it do in production;
  * ``A``: ``attach_device_bank()`` swaps in a fresh bank (an epoch begun
    on the old one completes there);
  * ``C``: one phase of an IVF re-cluster job (begin, compute, commit).

Each package's run asserts the harness invariants: every flip publishes the
host slab as it was at the epoch's begin, row for row; a policy scan
leaves at most ``max_lag_rows`` rows unpublished; the index's posting
lists stay consistent after every token; the drained store converges. For
every ``S`` token both packages serve the same generation (per bank) of
the same mutation prefix and the same uids, with scores within 1e-6 (the
two packages sum in different orders); the port's scan equals the port's
own sync-refresh oracle store, replayed to that prefix, bit for bit.
"""
import itertools
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.store import EmbeddingStore as JStore
from repro_torch.core import retrieval as RT
from repro_torch.core.store import EmbeddingStore as TStore

E = 32
TOL = 1e-6  # reference vs port scores: fp32 dots in another order


def _embs(n, e=E, seed=0):
    return np.random.default_rng(seed).standard_normal((n, e)).astype(
        np.float32)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rows(a):
    """A snapshot's global rows: the port's shards (a tuple of tensors)
    concatenated in order, or the reference's one array."""
    return (torch.cat([t.cpu() for t in a]).numpy() if isinstance(a, tuple)
            else _np(a))


def _interleavings(counts, stride=1):
    """Every distinct ordering of ``counts[actor]`` tokens per actor, in
    lexicographic order, every ``stride``-th kept."""
    pool = "".join(a * c for a, c in sorted(counts.items()))
    return sorted(set("".join(p) for p in itertools.permutations(pool))
                  )[::stride]


def _apply(st, m):
    kind, uids, payload = m
    if kind == "add":
        st.add_batch(uids, payload, np.zeros(len(uids)), np.ones(len(uids)))
    elif kind == "upgrade":
        st.upgrade_batch(uids, payload)
    else:
        st.delete_batch(uids)


def _canon(u, s):
    """Per query, the (uid, score) pairs sorted by uid."""
    order = np.argsort(u, axis=1, kind="stable")
    return (np.take_along_axis(u, order, axis=1),
            np.take_along_axis(s, order, axis=1))


class Scenario:
    """One initial store, writer script and query set, run under many
    schedules on either package."""

    def __init__(self, *, freshness="stale", max_lag_rows=None, ivf=False,
                 clusters=4, n_initial=40, n_queries=3, k=5, seed=0,
                 shards=1):
        rng = np.random.default_rng(seed)
        self.init = rng.standard_normal((n_initial, E)).astype(np.float32)
        self.queries = rng.standard_normal((n_queries, E)).astype(np.float32)
        self.script = [
            ("add", np.arange(1000, 1006),
             rng.standard_normal((6, E)).astype(np.float32)),
            ("upgrade", np.array([3, 17, 29]),
             rng.standard_normal((3, E)).astype(np.float32)),
            ("delete", np.array([5, 11]), None)]
        self.freshness, self.max_lag_rows = freshness, max_lag_rows
        self.ivf, self.clusters, self.k = ivf, clusters, k
        self.impl = "ivf" if ivf else "device"
        self.shards = shards  # the port's bank; the reference's has one
        self._oracle = {}

    def attach(self, st):
        """(Re-)attach the device bank: the port's over ``shards`` CPU
        shards."""
        if isinstance(st, TStore):
            st.attach_device_bank(["cpu"] * self.shards)
        else:
            st.attach_device_bank()

    def build(self, pkg, prefix):
        st = (JStore(E, capacity=8) if pkg == "ref" else
              TStore(E, capacity=8, device="cpu"))
        if pkg == "port" and self.shards > 1:
            self.attach(st)
        n = len(self.init)
        st.add_batch(np.arange(n), self.init, np.zeros(n), np.ones(n))
        if self.ivf:  # nprobe = C: a fresh pruned scan covers every row
            st.attach_ivf(n_clusters=self.clusters, nprobe=self.clusters,
                          min_rows=1, train_batch=64)
        for m in self.script[:prefix]:
            _apply(st, m)
        return st

    def scan(self, st, freshness):
        u, s = st.search_batch(self.queries, self.k, impl=self.impl,
                               freshness=freshness)
        return _canon(u, s) if self.ivf else (u, s)

    def oracle(self, prefix):
        """The port's sync-refresh store replayed to ``prefix``."""
        if prefix not in self._oracle:
            self._oracle[prefix] = self.scan(self.build("port", prefix), None)
        return self._oracle[prefix]

    @staticmethod
    def _check_ivf(st):
        if st.ivf_index is not None:
            st.ivf_index.check_consistency(len(st), st.rows_of(st.uids()))

    @staticmethod
    def _check_flip(snap, begin):
        packed, scales, uids = begin
        n = snap.n
        assert n == len(uids) and np.array_equal(snap.uids, uids)
        assert np.array_equal(_rows(snap.packed)[:n], packed[:n])
        assert np.array_equal(_rows(snap.scales)[:n], scales[:n])

    def run(self, pkg, tokens):
        """Execute one schedule on ``pkg``; returns one record per ``S``
        token: (bank number, generation, mutation prefix served, writes
        applied, (uids, scores)), then the drained store's final scan."""
        st = self.build(pkg, 0)
        ref = st.set_bank_refresh("async", max_lag_rows=self.max_lag_rows,
                                  thread=False)
        assert ref.refresh_once()
        banks = [st.device_bank]

        def key(bank, gen):
            return next(i for i, b in enumerate(banks) if b is bank), gen

        prefix_of = {key(st.device_bank, st.device_bank.generation): 0}
        writes, epoch, phase, begin, e_prefix = 0, None, 0, None, 0
        job, c_phase = None, 0
        records = []

        def finish_epoch():
            nonlocal epoch, phase
            if phase == 1:
                ref.apply(epoch)
            snap = ref.flip(epoch)
            prefix_of[key(epoch.bank, snap.generation)] = e_prefix
            self._check_flip(snap, begin)
            epoch, phase = None, 0

        for t in tokens:
            if t == "W":
                _apply(st, self.script[writes])
                writes += 1
            elif t == "A":
                self.attach(st)
                banks.append(st.device_bank)
            elif t == "C":
                if c_phase == 0:
                    job = st.ivf_recluster_begin()
                    c_phase = 0 if job is None else 1
                elif c_phase == 1:
                    st.ivf_index.compute_assignments(job)
                    c_phase = 2
                else:
                    st.ivf_recluster_commit(job)
                    job, c_phase = None, 0
            elif t == "R":
                if phase == 0:
                    e_prefix = writes
                    begin = (st._packed[:st._n].copy(),
                             st._scales[:st._n].copy(),
                             st._meta["uid"][:st._n].copy())
                    epoch = ref.begin_epoch()
                    phase = 1
                elif phase == 1:
                    if epoch is not None:
                        ref.apply(epoch)
                    phase = 2
                else:
                    if epoch is not None:
                        finish_epoch()
                    epoch, phase = None, 0
            else:
                blocks = (self.freshness == "fresh" or (
                    self.freshness is None and not ref.within_bound())
                    or st.device_bank.published is None)
                if blocks and epoch is not None:
                    finish_epoch()
                g0 = key(st.device_bank, st.device_bank.generation)
                got = self.scan(st, self.freshness)
                g1 = key(st.device_bank, st.device_bank.generation)
                if g1 != g0:  # the policy refreshed inline, to "now"
                    prefix_of[g1] = writes
                if pkg == "port" and (not self.ivf or prefix_of[g1] == writes):
                    # a stale IVF generation under current posting lists
                    # maps onto no single prefix; it is held to the
                    # reference's instead
                    want = self.oracle(prefix_of[g1])
                    assert np.array_equal(got[0], want[0]) and \
                        np.array_equal(got[1], want[1]), (
                            f"scan at {g1} (prefix {prefix_of[g1]}) differs "
                            f"from the sync oracle under {tokens!r}")
                if self.freshness is None and self.max_lag_rows is not None:
                    assert ref.lag()[0] <= self.max_lag_rows
                records.append((*g1, prefix_of[g1], writes, got))
            if self.ivf:
                self._check_ivf(st)
        if epoch is not None:
            finish_epoch()
        if job is not None:
            if c_phase == 1:
                st.ivf_index.compute_assignments(job)
            st.ivf_recluster_commit(job)
            self._check_ivf(st)
        ref.refresh_once()
        final = self.scan(st, "stale")
        want = self.oracle(writes)
        if pkg == "port":
            assert np.array_equal(final[0], want[0]) and \
                np.array_equal(final[1], want[1])
        records.append(("drained", writes, final))
        return records


def _same_scan(got, want):
    (u_g, s_g), (u_w, s_w) = _canon(*got), _canon(*want)
    return np.array_equal(u_g, u_w) and np.abs(s_g - s_w).max() <= TOL


SCENARIOS = {
    # 210 schedules of 2 writes, one epoch and 2 stale scans, every 2nd
    "stale": (dict(freshness="stale"), {"W": 2, "R": 3, "S": 2}, 2, 105),
    # a delete, and a policy scan under max_lag_rows = 4
    "policy_bound": (dict(freshness=None, max_lag_rows=4),
                     {"W": 3, "R": 3, "S": 1}, 2, 70),
    # a bank re-attach mid-schedule: 1680 schedules, every 24th
    "reattach": (dict(freshness="stale"), {"W": 2, "R": 3, "S": 2, "A": 1},
                 24, 70),
    # IVF pruned scans with re-cluster phases: 5040 schedules, every 56th
    "ivf_fresh": (dict(freshness="fresh", ivf=True),
                  {"W": 2, "R": 3, "S": 1, "C": 3}, 56, 90),
    # stale IVF scans with a re-attach: 50400 schedules, every 800th
    "ivf_stale_reattach": (dict(freshness="stale", ivf=True),
                           {"W": 2, "R": 3, "S": 1, "C": 3, "A": 1}, 800, 63),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_enumerated_schedules_match_reference(name):
    _run_scenario(name)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_enumerated_schedules_over_two_shards_match_reference(name):
    """The same schedules with the port's bank over two CPU shards, 60
    initial rows: the writer's 6 adds cross the 64-row capacity, so the
    refresh that takes them grows the bank and moves rows 32-59 from shard
    1 to shard 0 (and a re-attach re-uploads over two shards). The
    reference's bank has one device; the sync oracle is the port's own
    two-shard store."""
    _run_scenario(name, shards=2, n_initial=60)


def _run_scenario(name, **scenario_kw):
    kw, counts, stride, n_sched = SCENARIOS[name]
    scen = Scenario(**kw, **scenario_kw)
    schedules = _interleavings(counts, stride)
    assert len(schedules) == n_sched
    stale = 0
    for sched in schedules:
        mine, theirs = scen.run("port", sched), scen.run("ref", sched)
        assert len(mine) == len(theirs) == counts["S"] + 1
        for a, b in zip(mine[:-1], theirs[:-1]):
            assert a[:4] == b[:4], (
                f"{sched!r}: the port served (bank, generation, prefix, "
                f"writes) {a[:4]}, the reference {b[:4]}")
            assert _same_scan(a[4], b[4]), f"{sched!r}: scans differ"
            stale += a[2] < a[3]
        assert mine[-1][1] == theirs[-1][1]
        assert _same_scan(mine[-1][2], theirs[-1][2])
    if kw["freshness"] == "stale":
        assert stale > 0  # some scans were served a lagging generation


# -- the cases of tests/test_bank_async.py ------------------------------------


def _store_with_rows(n=60):
    st = TStore(E, capacity=8, device="cpu")
    st.add_batch(np.arange(n), _embs(n), np.zeros(n), np.ones(n))
    return st


def _same_sets(a, b):
    for x, y in zip(a, b):
        assert set(x.tolist()) == set(y.tolist())


def test_stale_serving_within_row_bound():
    st = _store_with_rows()
    q = _embs(3, seed=5)
    ref = st.set_bank_refresh("async", max_lag_rows=8, thread=False)
    st.search_batch(q, 5, impl="device")            # publishes generation 1
    gen = st.device_bank.generation
    st.upgrade_batch([1, 2], _embs(2, seed=9))      # 2 dirty rows <= bound
    st.search_batch(q, 5, impl="device")
    assert st.device_bank.generation == gen          # served stale
    assert ref.n_stale_served >= 1 and ref.max_served_lag_rows == 2
    st.upgrade_batch(np.arange(10, 20), _embs(10, seed=10))  # 12 > bound
    st.search_batch(q, 5, impl="device")
    assert st.device_bank.generation > gen           # blocked, refreshed
    assert ref.lag() == (0, 0.0)


def test_fresh_and_stale_overrides():
    st = _store_with_rows()
    q = _embs(3, seed=5)
    ref = st.set_bank_refresh("async", max_lag_rows=None, thread=False)
    st.search_batch(q, 5, impl="device")
    gen = st.device_bank.generation
    st.upgrade_batch(np.arange(30), _embs(30, seed=11))
    st.search_batch(q, 5, impl="device")             # unbounded: stale
    assert st.device_bank.generation == gen
    st.search_batch(q, 5, impl="device", freshness="stale")
    assert st.device_bank.generation == gen
    u, _ = st.search_batch(q, 5, impl="device", freshness="fresh")
    assert st.device_bank.generation > gen
    _same_sets(u, st.search_batch(q, 5, impl="numpy")[0])
    with pytest.raises(ValueError):
        ref.snapshot_for_query("fresh-ish")


def test_time_bound_blocks_old_writes():
    st = _store_with_rows()
    q = _embs(3, seed=5)
    st.set_bank_refresh("async", max_lag_ms=5.0, thread=False)
    st.search_batch(q, 5, impl="device")
    gen = st.device_bank.generation
    st.upgrade_batch([4], _embs(1, seed=12))
    time.sleep(0.02)                                 # older than the bound
    st.search_batch(q, 5, impl="device")
    assert st.device_bank.generation > gen


def test_sync_mode_unchanged_and_mode_switch_drains():
    st = _store_with_rows()
    q = _embs(3, seed=6)
    st.search_batch(q, 5, impl="device")             # sync by default
    assert st.bank_refresher is None
    ref = st.set_bank_refresh("async", thread=False)
    st.upgrade_batch([7], _embs(1, seed=13))
    assert ref.lag()[0] == 1
    st.set_bank_refresh("sync")                      # drains pending dirt
    assert st.bank_refresher is None
    assert st.device_bank.published.n == len(st)
    _same_sets(st.search_batch(q, 5, impl="device")[0],
               st.search_batch(q, 5, impl="numpy")[0])


def test_epoch_slicing_keeps_posthandoff_writes_for_next_epoch():
    st = _store_with_rows()
    ref = st.set_bank_refresh("async", thread=False)
    ref.refresh_once()
    st.upgrade_batch([1], _embs(1, seed=14))
    epoch = ref.begin_epoch()
    assert epoch.rows.tolist() == [1]
    st.upgrade_batch([2], _embs(1, seed=15))         # after the handoff
    ref.apply(epoch)
    ref.flip(epoch)
    assert ref.lag()[0] == 1                         # row 2 still pending
    assert ref.refresh_once()                        # the next epoch takes it
    assert ref.lag()[0] == 0


def test_apply_failure_requeues_dirty_rows():
    st = _store_with_rows()
    q = _embs(3, seed=8)
    ref = st.set_bank_refresh("async", thread=False)
    ref.refresh_once()
    st.upgrade_batch([3, 4], _embs(2, seed=16))
    bank = st.device_bank
    calls = {"n": 0}

    def boom(*a, **kw):
        calls["n"] += 1
        raise RuntimeError("injected device failure")

    bank.apply_rows = boom
    with pytest.raises(RuntimeError):
        ref.refresh_once()
    del bank.apply_rows
    assert calls["n"] == 1
    assert ref.lag()[0] == 2                          # rows requeued
    assert ref.refresh_once()
    _same_sets(st.search_batch(q, 5, impl="device", freshness="stale")[0],
               st.search_batch(q, 5, impl="numpy")[0])


def test_failed_growth_epoch_retries_cleanly():
    """A grow epoch that dies mid-scatter publishes nothing: the capacity
    stays, the rows are requeued, and the retry grows again."""
    st = TStore(E, capacity=8, device="cpu")
    st.add_batch(np.arange(40), _embs(40), np.zeros(40), np.ones(40))
    q = _embs(2, seed=21)
    ref = st.set_bank_refresh("async", thread=False)
    st.search_batch(q, 5, impl="device")
    bank = st.device_bank
    cap0, gen0 = bank.capacity, bank.generation
    st.add_batch(np.arange(100, 200), _embs(100, seed=22), np.zeros(100),
                 np.ones(100))
    calls = {"n": 0}

    def boom(*a, **kw):
        calls["n"] += 1
        raise RuntimeError("injected failure mid-grow")

    bank._scatter = boom
    with pytest.raises(RuntimeError):
        ref.refresh_once()
    del bank._scatter
    assert calls["n"] == 1
    assert bank.capacity == cap0 and bank.generation == gen0
    assert ref.lag()[0] == 100                        # rows requeued
    assert ref.refresh_once()                         # retry grows again
    assert bank.capacity > cap0 and bank.n_grows == 1
    _same_sets(st.search_batch(q, 8, impl="device", freshness="stale")[0],
               st.search_batch(q, 8, impl="numpy")[0])
    st.set_bank_refresh("sync")


def test_sync_query_during_scheduler_teardown_is_serialized():
    st = _store_with_rows()
    q = _embs(3, seed=23)
    st.search_batch(q, 5, impl="device")
    errors = []
    stop = threading.Event()

    def scanner():
        try:
            while not stop.is_set():
                st.search_batch(q, 5, impl="device")
        except Exception as e:  # surfaced below
            errors.append(e)

    t = threading.Thread(target=scanner)
    t.start()
    try:
        for i in range(12):
            st.set_bank_refresh("async", max_lag_rows=0)
            st.upgrade_batch([i % 60], _embs(1, seed=50 + i))
            st.set_bank_refresh("sync")
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive() and not errors, errors
    _same_sets(st.search_batch(q, 5, impl="device")[0],
               st.search_batch(q, 5, impl="numpy")[0])


def test_staleness_accounting_exact():
    st = _store_with_rows(n=10)
    ref = st.set_bank_refresh("async", thread=False)
    ref.refresh_once()
    st.add_batch([7, 7], _embs(2, seed=30), [0, 0], [1, 1])  # one row twice
    assert ref.lag()[0] == 1
    st.upgrade_batch([7, 7], _embs(2, seed=31))
    assert ref.lag()[0] == 1
    ref.refresh_once()
    st.add_batch([99], _embs(1, seed=32), [0], [1])
    assert ref.lag()[0] == 1
    st.delete_batch([99])                      # the dirty tail row goes
    assert ref.lag() == (0, 0.0)
    assert st._bank_first_dirty_t is None
    time.sleep(0.02)
    st.upgrade_batch([3], _embs(1, seed=33))
    rows, ms = ref.lag()
    assert rows == 1 and ms < 15.0             # a fresh stamp
    st.set_bank_refresh("sync")


def test_delete_shrinks_published_n_and_tail_is_masked():
    st = _store_with_rows(n=20)
    q = _embs(3, seed=4)
    st.set_bank_refresh("async", thread=False)
    st.search_batch(q, 5, impl="device")
    st.delete_batch([0, 19, 7])
    u, _ = st.search_batch(q, 25, impl="device", freshness="fresh")
    assert st.device_bank.published.n == 17
    assert u.shape == (3, 17)
    assert not {0, 19, 7} & set(u.ravel().tolist())


def test_stale_snapshot_with_deleted_uid_does_not_crash_retrieval():
    st = _store_with_rows(n=30)
    target = _embs(30)[7]
    st.set_bank_refresh("async", thread=False)
    st.search_batch(target[None], 5, impl="device")
    st.delete_batch([7])
    u, _ = st.search_batch(target[None], 5, impl="device", freshness="stale")
    assert 7 in u.ravel().tolist()             # stale semantics
    res = RT.speculative_retrieve(st, [target], fine_query=target, k=5,
                                  refine_fn=None, impl="device",
                                  freshness="stale")
    assert 7 not in res.uids.tolist() + res.filtered_uids.tolist()
    st.set_bank_refresh("sync")


def test_threaded_refresher_mixed_workload_converges():
    st = _store_with_rows(n=80)
    q = _embs(4, seed=3)
    ref = st.set_bank_refresh("async", max_lag_rows=64)
    st.search_batch(q, 5, impl="device")
    rng = np.random.default_rng(0)
    stop = threading.Event()
    errors = []

    def writer():
        try:
            i = 0
            while not stop.is_set():
                if i % 3 == 0:
                    st.add_batch([2000 + i], _embs(1, seed=100 + i), [0], [1])
                elif i % 3 == 1:
                    st.upgrade_batch([int(rng.integers(0, 80))],
                                     _embs(1, seed=200 + i))
                else:
                    st.delete_batch([2000 + i - 2])
                i += 1
                time.sleep(0.001)
        except Exception as e:  # surfaced below
            errors.append(e)

    t = threading.Thread(target=writer)
    t.start()
    try:
        for _ in range(60):
            u, s = st.search_batch(q, 5, impl="device")
            assert u.shape == (4, 5) and (np.diff(s, axis=1) <= 1e-6).all()
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive() and not errors, errors
    assert ref.max_served_lag_rows <= 64
    st.set_bank_refresh("sync")
    _same_sets(st.search_batch(q, 5, impl="device")[0],
               st.search_batch(q, 5, impl="numpy")[0])
    assert ref.n_epochs > 0


# -- IVF under the async refresh ----------------------------------------------


def _clustered(rng, n, n_centers=6):
    from repro_torch.data.synthetic import clustered_sphere
    return clustered_sphere(rng, n, n_centers, E, spread=0.12)


def test_ivf_async_refresh_reclusters_on_the_epoch():
    rng = np.random.default_rng(12)
    data, _ = _clustered(rng, 400)
    st = TStore(E, capacity=16, device="cpu")
    st.attach_ivf(n_clusters=4, nprobe=4, min_rows=1, train_batch=64)
    ref = st.set_bank_refresh("async", max_lag_rows=0, thread=False)
    st.add_batch(np.arange(400), data, np.zeros(400), np.ones(400))
    st.ivf_index._drift = 1.0  # force the trigger
    ref.refresh_once()         # the piggyback point: an epoch, then a job
    assert st.ivf_maybe_recluster()
    st.ivf_index.check_consistency(len(st), st.rows_of(st.uids()))
    q = rng.standard_normal((3, E)).astype(np.float32)
    _same_sets(st.search_batch(q, 10, impl="ivf", freshness="fresh")[0],
               st.search_batch(q, 10, impl="numpy")[0])
    st.set_bank_refresh("sync")


def test_ivf_union_and_gathered_agree_on_stale_snapshot():
    """Postings ahead of a stale snapshot both ways (swap-with-last deletes
    recycle rows < snap.n, adds append rows >= snap.n): both strategies
    serve the snapshot's (uid, score) pairs and no later row, on both
    packages alike."""
    rng = np.random.default_rng(14)
    data, centers = _clustered(rng, 300, n_centers=5)
    extra = rng.standard_normal((30, E)).astype(np.float32)
    q = (centers[rng.integers(0, len(centers), 5)] +
         0.2 * rng.standard_normal((5, E))).astype(np.float32)
    out = {}
    for pkg, st in (("ref", JStore(E, capacity=16)),
                    ("port", TStore(E, capacity=16, device="cpu"))):
        st.attach_ivf(n_clusters=5, nprobe=5, min_rows=1, train_batch=64)
        st.add_batch(np.arange(300), data, np.zeros(300), np.ones(300))
        ref = st.set_bank_refresh("async", thread=False)
        assert ref.refresh_once()
        st.delete_batch(np.arange(0, 40, 2))
        st.add_batch(np.arange(1000, 1030), extra, np.zeros(30), np.ones(30))
        assert len(st) == 310 and st.device_bank.published.n == 300
        out[pkg] = [st.search_batch(q, 10, impl="ivf", freshness="stale",
                                    strategy=s) for s in ("union", "gathered")]
        st.set_bank_refresh("sync")
    for (u, s), (uj, sj) in zip(out["port"], out["ref"]):
        assert (u < 1000).all()               # no post-snapshot row
        assert _same_scan((u, s), (uj, sj))
    assert _same_scan(out["port"][0], out["port"][1])


def test_async_ivf_query_rebinds_after_bank_reattach(monkeypatch):
    rng = np.random.default_rng(17)
    data, _ = _clustered(rng, 200, n_centers=4)
    st = TStore(E, capacity=16, device="cpu")
    st.attach_ivf(n_clusters=4, nprobe=4, min_rows=1, train_batch=64)
    st.add_batch(np.arange(200), data, np.zeros(200), np.ones(200))
    ref = st.set_bank_refresh("async", thread=False)
    assert ref.refresh_once()
    old_bank = st.device_bank
    calls = {"n": 0}
    real = ref.snapshot_for_query

    def racing(freshness=None):
        snap = real(freshness)
        if calls["n"] == 0:   # a swap lands after the snapshot was taken
            st.attach_device_bank()
            ref.refresh_once()
        calls["n"] += 1
        return snap

    monkeypatch.setattr(ref, "snapshot_for_query", racing)
    q = rng.standard_normal((3, E)).astype(np.float32)
    iu, _ = st.search_batch(q, 10, impl="ivf", freshness="stale")
    assert calls["n"] >= 2 and st.device_bank is not old_bank
    monkeypatch.undo()
    _same_sets(iu, st.search_batch(q, 10, impl="numpy")[0])
    st.set_bank_refresh("sync")
