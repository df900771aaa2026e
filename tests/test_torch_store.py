"""Port parity: the same add/upgrade/delete/query sequence through the
reference's EmbeddingStore and the port's gives the same rows, uid sets and
scores, on the numpy path and on the device-bank path (the port's bank on
the CPU runs the plain version of the int4 scan)."""
import numpy as np
import pytest
import torch

from repro.core.store import EmbeddingStore as JStore
from repro_torch.core.store import EmbeddingStore as TStore

E = 32
TOL = 1e-5


def _unit(rng, n):
    x = rng.standard_normal((n, E)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assert_same_topk(got, want):
    (u_g, s_g), (u_w, s_w) = got, want
    assert u_g.shape == u_w.shape
    np.testing.assert_allclose(s_g, s_w, atol=TOL, rtol=0)
    sep = np.ones(s_w.shape, bool)
    d = np.abs(np.diff(s_w, axis=1)) > TOL
    sep[:, 1:] &= d
    sep[:, :-1] &= d
    sep[:, -1] = False
    np.testing.assert_array_equal(u_g[sep], u_w[sep])


def _check_searches(js, ts, rng, k=5):
    q = _unit(rng, 7)
    for impl in ("numpy", "device"):
        got = ts.search_batch(q, k, impl=impl)
        _assert_same_topk(got, js.search_batch(q, k, impl=impl))
        # every returned uid is live (rows past n are masked)
        assert ts.contains(got[0].ravel()).all()
    u, s = ts.search(q[0], k)
    uj, sj = js.search(q[0], k)
    _assert_same_topk((u[None], s[None]), (uj[None], sj[None]))


def test_store_sequence_matches_reference():
    rng = np.random.default_rng(0)
    js = JStore(E, capacity=4)
    ts = TStore(E, capacity=4, device="cpu")
    js.attach_device_bank()
    ts.attach_device_bank()
    bank_rows = 0

    def both(fn):
        fn(js)
        fn(ts)

    embs = _unit(rng, 10)
    acts = rng.standard_normal((10, 5, E)).astype(np.float32)
    both(lambda s: s.add_batch(np.arange(10), embs, [1] * 10, [4] * 10,
                               modality="vision", cached_hs=acts))
    _check_searches(js, ts, rng)
    bank_rows += 10
    # capacity doubles twice on the host and on the bank (16 -> 64 rows)
    embs2 = _unit(rng, 30)
    both(lambda s: s.add_batch(np.arange(10, 40), embs2, [0] * 30, [2] * 30))
    _check_searches(js, ts, rng)
    bank_rows += 30
    fine = _unit(rng, 3)
    both(lambda s: s.upgrade_batch([3, 17, 25], fine))
    bank_rows += 3
    # deletes: the last row, a middle row, and a cached one; swap-with-last
    # moves rows down and n shrinks, so the bank must mask the tail
    both(lambda s: s.delete_batch([39, 12, 4]))
    bank_rows += 2  # rows 12 and 4 take the then-last rows; 39 was last
    _check_searches(js, ts, rng)
    new7 = _unit(rng, 1)
    both(lambda s: s.add_batch([7], new7, [2], [8]))  # overwrite in place
    bank_rows += 1
    _check_searches(js, ts, rng, k=12)

    assert len(ts) == len(js) == 37
    np.testing.assert_array_equal(ts.uids(), js.uids())
    np.testing.assert_array_equal(ts.dense_matrix(), js.dense_matrix())
    np.testing.assert_array_equal(ts.get_embeddings([3, 17, 0]),
                                  js.get_embeddings([3, 17, 0]))
    np.testing.assert_array_equal(ts.is_fine([3, 17, 0]), js.is_fine([3, 17, 0]))
    probe = [0, 4, 7, 12, 39, 100]
    np.testing.assert_array_equal(ts.contains(probe), js.contains(probe))
    assert ts.storage_bytes() == js.storage_bytes()
    np.testing.assert_array_equal(ts.exit_histogram(3), js.exit_histogram(3))
    ca_t, ca_j = ts.cached_activations(range(10)), js.cached_activations(range(10))
    assert sorted(ca_t) == sorted(ca_j) and 3 not in ca_t and 7 not in ca_t
    for u in ca_j:
        np.testing.assert_array_equal(ca_t[u][0], ca_j[u][0])
        assert ca_t[u][1] == ca_j[u][1]

    tb, jb = ts.device_bank.stats(), js.device_bank.stats()
    for key in ("h2d_rows", "n_syncs", "n_grows", "capacity", "n",
                "generation"):
        assert tb[key] == jb[key], key
    assert tb["h2d_rows"] == bank_rows
    # only dirty rows travel: packed row + scale + int64 row index each
    assert tb["h2d_bytes"] == bank_rows * (E // 2 + 4 + 8)
    # a steady-state query moves nothing
    ts.search_batch(_unit(rng, 2), 3, impl="device")
    assert ts.device_bank.stats()["h2d_bytes"] == tb["h2d_bytes"]


def test_bank_mirrors_host_slab_bit_exactly():
    rng = np.random.default_rng(1)
    ts = TStore(E, capacity=2, device="cpu")
    ts.add_batch(np.arange(9), _unit(rng, 9), [0] * 9, [1] * 9)
    ts.search_batch(_unit(rng, 1), 3, impl="device")
    ts.delete_batch([2, 8])
    ts.search_batch(_unit(rng, 1), 3, impl="device")
    snap = ts.device_bank.published
    assert snap.n == 7
    assert len(snap.packed) == len(snap.scales) == 1  # one shard on the CPU
    np.testing.assert_array_equal(snap.packed[0][:7].numpy(), ts._packed[:7])
    np.testing.assert_array_equal(snap.scales[0][:7].numpy(), ts._scales[:7])
    np.testing.assert_array_equal(snap.uids, ts.uids())


def test_auto_follows_the_requested_device():
    ts = TStore(E, device="cpu")
    assert ts.resolve_impl("auto") == "numpy"
    ts.device = torch.device("cuda")  # what a store put on a card resolves to
    assert ts.resolve_impl("auto") == "device"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TStore(E)  # default device is CUDA: no silent CPU fallback


def test_attach_device_bank_defaults_to_the_stores_devices():
    """A CPU store's bank is one CPU shard; a list makes one shard an
    entry, and a re-attach re-uploads every row over the new layout."""
    ts = TStore(E, device="cpu")
    ts.add_batch(np.arange(5), _unit(np.random.default_rng(3), 5),
                 [0] * 5, [1] * 5)
    bank = ts.attach_device_bank()
    assert bank.n_shards == 1 and bank.devices == [torch.device("cpu")]
    ts.search_batch(_unit(np.random.default_rng(4), 1), 2, impl="device")
    sharded = ts.attach_device_bank(["cpu", "cpu", "cpu"])
    assert sharded is ts.device_bank and sharded.n_shards == 3
    ts.search_batch(_unit(np.random.default_rng(4), 1), 2, impl="device")
    assert sharded.stats()["h2d_rows"] == 5
    assert [sharded.published.n_local(s) for s in range(3)] == [5, 0, 0]
