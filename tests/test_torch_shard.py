"""Port parity for the row-sharded device bank: shards are a list of devices
in one process (here the CPU, repeated, so the plain versions of the
kernels run), held against the reference's one-device bank over the same
mutations and against the port's own one-shard bank; the shard routing
(``partition_rows_by_shard``), the merge (``topk_allgather_merge``), the
store's fp32 mode and its per-item API against the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.store import EmbeddingStore as JStore
from repro.data.synthetic import clustered_sphere
from repro.index import pruned_scan as JP
from repro_torch.core.device_bank import DeviceBank
from repro_torch.core.store import EmbeddingStore as TStore
from repro_torch.core.store import StoreEntry
from repro_torch.distributed.collectives import topk_allgather_merge
from repro_torch.index import pruned_scan as TP
from repro_torch.kernels.retrieval_topk import ops as topk_ops

E = 32
TOL = 1e-5  # fp32 dots of unit vectors, another summation order


def _unit(rng, n, e=E):
    x = rng.standard_normal((n, e)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _same_topk(got, want, tol=TOL):
    """Scores within ``tol``; ids equal where the scores are separated."""
    (u_g, s_g), (u_w, s_w) = got, want
    assert u_g.shape == u_w.shape
    np.testing.assert_allclose(s_g, s_w, atol=tol, rtol=0)
    sep = np.ones(s_w.shape, bool)
    d = np.abs(np.diff(s_w, axis=1)) > tol
    sep[:, 1:] &= d
    sep[:, :-1] &= d
    sep[:, -1] = False
    np.testing.assert_array_equal(u_g[sep], u_w[sep])


# -- routing and merge ------------------------------------------------------


@pytest.mark.parametrize("rows,rps,n_shards,min_width", [
    ([], 8, 3, 1),                          # no candidates
    ([], 8, 2, 5),
    ([5, 1, 7, 0], 8, 1, 1),                # one shard
    ([9, 3, 30, 17, 2, 26, 8], 8, 4, 1),    # every shard, out of order
    ([1, 2, 3, 25], 8, 4, 1),               # shards 1 and 2 get nothing
    ([40, 41, 47], 16, 3, 8),               # only the last shard, floored
    (list(range(0, 3000, 3)), 1024, 3, 1),  # past the 3/4 bucket step
])
def test_partition_rows_by_shard_matches_reference(rows, rps, n_shards,
                                                   min_width):
    rows = np.array(rows, np.int64)
    want = JP.partition_rows_by_shard(rows, rps, n_shards,
                                      min_width=min_width)
    got = TP.partition_rows_by_shard(rows, rps, n_shards,
                                     min_width=min_width)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_partition_rows_outside_the_slab_raise():
    with pytest.raises(ValueError, match="outside"):
        TP.partition_rows_by_shard(np.array([3, 16]), 8, 2)
    with pytest.raises(AssertionError):
        JP.partition_rows_by_shard(np.array([3, 16]), 8, 2)


@pytest.mark.parametrize("n_shards,k_loc,k", [(2, 5, 5), (3, 4, 7),
                                              (4, 6, 24), (1, 3, 2)])
def test_topk_allgather_merge_matches_lax_top_k(n_shards, k_loc, k):
    """The port's merge equals the reference's all-gather + ``lax.top_k``
    over the per-shard sets concatenated in shard order, ties included
    (scores from a handful of values: the lower shard wins a tie)."""
    rng = np.random.default_rng(n_shards * 10 + k)
    s = [np.sort(rng.integers(0, 4, (5, k_loc)).astype(np.float32),
                 axis=1)[:, ::-1].copy() for _ in range(n_shards)]
    ids = [rng.integers(0, 1000, (5, k_loc)).astype(np.int32)
           for _ in range(n_shards)]
    top_s, sel = jax.lax.top_k(jnp.concatenate(s, axis=1), k)
    want_i = np.take_along_axis(np.concatenate(ids, axis=1),
                                np.asarray(sel), axis=1)
    got_s, got_i = topk_allgather_merge([torch.from_numpy(a) for a in s],
                                        [torch.from_numpy(a) for a in ids],
                                        k)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(top_s))
    np.testing.assert_array_equal(got_i.numpy(), want_i)


# -- the sharded bank --------------------------------------------------------


def _stores(n_shards, n, seed=0, store_int4=True):
    """The same n rows in the reference's store (one device), the port's
    one-shard store and its n_shards-shard store, capacity 64."""
    data = _unit(np.random.default_rng(seed), n)
    js = JStore(E, store_int4=store_int4, capacity=64)
    one = TStore(E, store_int4=store_int4, capacity=64, device="cpu")
    many = TStore(E, store_int4=store_int4, capacity=64, device="cpu")
    one.attach_device_bank()
    many.attach_device_bank(["cpu"] * n_shards)
    for st in (js, one, many):
        st.add_batch(np.arange(n), data, np.zeros(n), np.ones(n))
    return js, one, many


def _check_scans(js, one, many, rng, ks=(3, 10, 25)):
    q = _unit(rng, 6)
    for k in ks:
        got = many.search_batch(q, k, impl="device")
        _same_topk(got, js.search_batch(q, k, impl="device"))
        _same_topk(got, one.search_batch(q, k, impl="device"))
        assert many.contains(got[0].ravel()).all()


# (shards, rows): capacity 64 is 32 / 22 / 16 rows a shard; the last shard
# is wholly empty at (2, 20) and (4, 40), partly filled at (3, 50), and
# every shard is full at (4, 64)
@pytest.mark.parametrize("n_shards,n", [(2, 20), (3, 50), (4, 40), (4, 64)])
def test_sharded_exhaustive_scan_matches_one_device(n_shards, n):
    js, one, many = _stores(n_shards, n, seed=n)
    rng = np.random.default_rng(1)
    _check_scans(js, one, many, rng)
    bank = many.device_bank
    st = bank.stats()
    assert st["n_shards"] == n_shards == len(bank.published.packed)
    # the host capacity rounded up to a multiple of the shard count
    assert js.device_bank.stats()["capacity"] == 64
    assert st["capacity"] == 64 + (-64) % n_shards
    rps = st["capacity"] // n_shards
    assert [bank.published.n_local(s) for s in range(n_shards)] == [
        max(0, min(n - s * rps, rps)) for s in range(n_shards)]
    assert st["device_bytes"] == st["capacity"] * (E // 2 + 4)
    assert one.device_bank.stats()["device_bytes"] == 64 * (E // 2 + 4)


@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_sharded_bank_follows_mutations_and_grows_across_shards(n_shards):
    """Upgrades, deletes (swap-with-last moves rows between shards) and a
    capacity doubling (rows per shard double, so rows move between
    shards): every scan matches the one-device banks, the
    shards hold the host slab row for row, and only dirty rows travel (a
    grow moves rows device to device)."""
    js, one, many = _stores(n_shards, 40, seed=n_shards)
    rng = np.random.default_rng(2)
    _check_scans(js, one, many, rng)
    bank = many.device_bank
    written = 40

    def both(fn):
        for st in (js, one, many):
            fn(st)

    fine = _unit(rng, 4)
    both(lambda s: s.upgrade_batch([1, 17, 33, 39], fine))
    written += 4
    # row 2 takes the last row (39, dirty from the upgrade, whose own dirt
    # then goes), and 38 is then the last row: no new dirty row on balance
    both(lambda s: s.delete_batch([2, 38]))
    _check_scans(js, one, many, rng)
    rows_before, grows_before = bank.h2d_rows, bank.n_grows
    assert rows_before == written
    extra = _unit(rng, 90)
    both(lambda s: s.add_batch(np.arange(100, 190), extra, np.zeros(90),
                               np.ones(90)))
    written += 90
    _check_scans(js, one, many, rng, ks=(5, 40))
    assert bank.n_grows == grows_before + 1 == one.device_bank.n_grows
    assert bank.h2d_rows == one.device_bank.h2d_rows == written
    snap = bank.published
    assert many._cap == 128 and snap.capacity == 128 + (-128) % n_shards
    rows = torch.cat(snap.packed)[:len(many)].numpy()
    np.testing.assert_array_equal(rows, many._packed[:len(many)])
    np.testing.assert_array_equal(torch.cat(snap.scales)[:len(many)].numpy(),
                                  many._scales[:len(many)])
    # a steady-state query moves nothing
    h2d = bank.h2d_bytes
    many.search_batch(_unit(rng, 2), 3, impl="device")
    assert bank.h2d_bytes == h2d


def test_a_grow_builds_new_shards_without_writing_published_ones():
    """Copy-on-write across a grow: the snapshot published before it keeps
    its tensors and answers as before."""
    bank = DeviceBank(E, devices=["cpu"] * 3, device="cpu")
    rng = np.random.default_rng(3)
    st = TStore(E, capacity=8, device="cpu")
    st.add_batch(np.arange(30), _unit(rng, 30), np.zeros(30), np.ones(30))
    old = bank.sync(st._packed, st._scales, 30, np.arange(30), st.uids())
    q = _unit(rng, 3)
    want = bank.search(q, 5, state=old)
    kept = [t.clone() for t in old.packed]
    st.add_batch(np.arange(30, 100), _unit(rng, 70), np.zeros(70),
                 np.ones(70))
    new = bank.sync(st._packed, st._scales, 100, np.arange(30, 100),
                    st.uids())
    assert new.rows_per_shard > old.rows_per_shard
    assert all(torch.equal(a, b) for a, b in zip(old.packed, kept))
    got = bank.search(q, 5, state=old)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                              want[1])


def _ivf_stores(n_shards, n=200, seed=2):
    data = clustered_sphere(np.random.default_rng(seed), n + 8, 6, E,
                            spread=0.12)[0]
    js = JStore(E, capacity=8)
    one = TStore(E, capacity=8, device="cpu")
    many = TStore(E, capacity=8, device="cpu")
    many.attach_device_bank(["cpu"] * n_shards)
    for st in (js, one, many):
        st.attach_ivf(n_clusters=5, nprobe=2, min_rows=64, train_batch=32)
        for lo in range(0, n, 50):
            st.add_batch(np.arange(lo, lo + 50), data[lo:lo + 50],
                         np.zeros(50), np.ones(50))
        st.upgrade_batch([3, 50, 111], data[n:n + 3])
        st.delete_batch([7, 120, n - 1])
    return js, one, many


@pytest.mark.parametrize("strategy", ["union", "gathered"])
@pytest.mark.parametrize("n_shards,nprobe,k", [(2, 2, 10), (3, 1, 80),
                                               (4, 5, 10)])
def test_sharded_pruned_scans_match_one_device(n_shards, strategy, nprobe,
                                               k):
    js, one, many = _ivf_stores(n_shards)
    q = clustered_sphere(np.random.default_rng(3), 11, 6, E,
                         spread=0.12)[0]
    counts = (topk_ops.launches, topk_ops.launches_gathered)
    got = many.search_batch(q, k, impl="ivf", nprobe=nprobe,
                            strategy=strategy)
    for other in (js, one):
        want = other.search_batch(q, k, impl="ivf", nprobe=nprobe,
                                  strategy=strategy)
        _same_topk(got, want)
        assert (got[0] == -1).sum() == (want[0] == -1).sum()
    assert many.ivf_fallbacks == 0 and many.device_bank.n_shards == n_shards
    # CPU tensors take the plain versions: no launch is counted
    assert (topk_ops.launches, topk_ops.launches_gathered) == counts


@pytest.mark.parametrize("n_shards", [2, 4])
def test_bank_pruned_entries_with_explicit_candidates(n_shards):
    """``search_rows`` and ``search_gathered`` straight on the banks, with
    candidates in some shards only, ids past the fill and padding: the
    sharded bank equals the reference's and the port's one-device
    banks."""
    js, one, many = _stores(n_shards, 40, seed=5)
    rng = np.random.default_rng(6)
    q = _unit(rng, 4)
    banks = []
    for st in (js, one, many):
        st.search_batch(q, 1, impl="device")  # publish
        banks.append((st.device_bank, st.device_bank.published))
    rows = np.array([3, 0, 9, 12, 5, 1, 11])  # the first 16 rows only
    for k in (2, 7):
        want = banks[0][0].search_rows(q, rows, k, state=banks[0][1])
        for bank, snap in banks[1:]:
            _same_topk(bank.search_rows(q, rows, k, state=snap), want)
    ids = rng.integers(-1, 40, (4, 12)).astype(np.int32)
    ids[:, -3:] = [50, 63, -1]  # past the fill, padding
    ids[3] = -1                 # a query with no live candidate
    for k in (3, 16):
        want = banks[0][0].search_gathered(q, ids, k, state=banks[0][1])
        for bank, snap in banks[1:]:
            got = bank.search_gathered(q, ids, k, state=snap)
            _same_topk(got, want)
            np.testing.assert_array_equal(got[0] == -1, want[0] == -1)
            assert (got[0][3] == -1).all() and (got[1][3] <= -1e29).all()


@pytest.mark.parametrize("strategy", ["union", "gathered"])
def test_fewer_live_candidates_than_k_pad_with_the_sentinel(strategy):
    """A probed cluster holding fewer rows than k: both packages pad with
    (uid -1, score -1e30), the sharded bank included."""
    data = clustered_sphere(np.random.default_rng(7), 60, 4, E,
                            spread=0.05)[0]
    out = []
    for st in (JStore(E, capacity=8), TStore(E, capacity=8, device="cpu"),
               TStore(E, capacity=8, device="cpu")):
        if isinstance(st, TStore) and out:
            st.attach_device_bank(["cpu"] * 3)
        st.attach_ivf(n_clusters=8, nprobe=1, min_rows=1, train_batch=64)
        st.add_batch(np.arange(60), data, np.zeros(60), np.ones(60))
        out.append(st.search_batch(data[:2], 40, impl="ivf",
                                   strategy=strategy))
    for got in out[1:]:
        _same_topk(got, out[0])
        np.testing.assert_array_equal(got[0] == -1, out[0][0] == -1)
    assert (out[2][0] == -1).any()
    assert (out[2][1][out[2][0] == -1] <= -1e29).all()


# -- fp32 mode -----------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 3])
def test_device_path_fp32_store_mode(n_shards):
    """``store_int4=False`` banks fp32 rows and scans them with the dense
    scan, against the numpy path and the reference's fp32 store (the port
    of tests/test_device_bank.py's case, sharded too)."""
    rng = np.random.default_rng(8)
    embs = rng.standard_normal((50, 16)).astype(np.float32)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    js = JStore(16, store_int4=False, capacity=4)
    ts = TStore(16, store_int4=False, capacity=4, device="cpu")
    ts.attach_device_bank(["cpu"] * n_shards)
    for st in (js, ts):
        st.add_batch(np.arange(50), embs, np.zeros(50), np.ones(50))
    assert ts._packed.dtype == np.float32 and ts._packed.shape[1] == 16
    np.testing.assert_array_equal(ts.dense_matrix(), js.dense_matrix())
    np.testing.assert_array_equal(ts.dense_matrix(), embs)
    nu, ns = ts.search_batch(q, 5, impl="numpy")
    du, ds = ts.search_batch(q, 5, impl="device")
    np.testing.assert_allclose(ds, ns, atol=1e-5)
    for a, b in zip(nu, du):
        assert set(a.tolist()) == set(b.tolist())
    _same_topk((du, ds), js.search_batch(q, 5, impl="device"))
    assert ts.storage_bytes() == js.storage_bytes()
    bank = ts.device_bank
    assert not bank.store_int4 and bank.published.packed[0].dtype == \
        torch.float32
    with pytest.raises(NotImplementedError, match="int4 bank"):
        bank.search_rows(q, np.arange(10), 3)
    with pytest.raises(NotImplementedError, match="int4 bank"):
        bank.search_gathered(q, np.zeros((4, 8), np.int32), 3)
    with pytest.raises(ValueError, match="store_int4"):
        ts.attach_ivf()
    with pytest.raises(AssertionError):
        js.attach_ivf()


def test_fp32_store_takes_an_odd_width():
    ts = TStore(7, store_int4=False, device="cpu")
    ts.add(3, np.arange(7, dtype=np.float32), exit_idx=0, exit_layer=1)
    np.testing.assert_array_equal(ts.get_embeddings([3])[0], np.arange(7))
    with pytest.raises(ValueError, match="even"):
        TStore(7, device="cpu")


# -- the per-item store API ----------------------------------------------------


def test_per_item_api_matches_reference():
    rng = np.random.default_rng(9)
    stores = (JStore(E, capacity=4), TStore(E, capacity=4, device="cpu"))
    embs = _unit(rng, 6)
    acts = rng.standard_normal((6, 3, E)).astype(np.float32)
    fine = _unit(rng, 2)
    for st in stores:
        for u in range(6):
            st.add(u, embs[u], exit_idx=u % 3, exit_layer=2 + u % 3,
                   modality="vision" if u % 2 else "text",
                   cached_h=acts[u] if u < 4 else None)
        st.upgrade(1, fine[0])
        st.upgrade(4, fine[1])
        st.delete(2)
    js, ts = stores
    assert ts.n_fine == js.n_fine == 2
    assert [e.__dict__ for e in ts.entries] == [e.__dict__
                                               for e in js.entries]
    assert isinstance(ts.entries[0], StoreEntry)
    for u in (0, 1, 3, 4, 5):
        assert ts.row_of(u) == js.row_of(u)
        assert ts.has_cached(u) == js.has_cached(u)
        a, b = ts.cached_activation(u), js.cached_activation(u)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]
    assert not ts.has_cached(1) and ts.cached_activation(2) is None
    with pytest.raises(KeyError):
        ts.row_of(2)
    with pytest.raises(KeyError):
        ts.delete(2)
    np.testing.assert_array_equal(ts.get_embeddings([1, 4]),
                                  js.get_embeddings([1, 4]))


def test_bank_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceBank(E, devices=["cpu", "cuda"])
    with pytest.raises(ValueError, match="at least one"):
        DeviceBank(E, devices=[])
