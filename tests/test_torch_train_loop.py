"""Port parity: the training loop's host side (``optim.schedule``,
``data.synthetic.lm_tokens``, ``data.pipeline.ShardedLoader``,
``distributed.straggler``) and ``launch.train.train_loop`` with a
checkpoint and a restart, against the reference."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JC
from repro.data import pipeline as JPL
from repro.data import synthetic as JSYN
from repro.distributed import straggler as JST
from repro.optim import schedule as JSCH
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import base as TC
from repro_torch.data import pipeline as TPL
from repro_torch.data import synthetic as TSYN
from repro_torch.distributed import straggler as TST
from repro_torch.launch import train as TTR
from repro_torch.optim import schedule as TSCH
from torch_train_common import (torch_threads,  # noqa: F401 (autouse)
                                leaf_errs, ref_run, to_np)

SCHEDULES = [("warmup_cosine", (3e-4, 20, 10000)),
             ("warmup_cosine", (2e-3, 5, 40)),
             ("warmup_cosine", (0.37, 7, 61, 0.25)),
             ("warmup_cosine", (1e-3, 0, 30)),
             ("constant", (3e-4,)),
             ("linear_warmup", (2e-3, 13)),
             ("linear_warmup", (1e-3, 0))]


@pytest.mark.parametrize("name,args", SCHEDULES,
                         ids=[f"{n}{a}" for n, a in SCHEDULES])
def test_schedule_matches_reference_in_float32(name, args):
    """Steps 0-60, as ``AdamW.update`` calls it (a Python int), a float
    holding a float32. Equal in float32 but past a cosine's warmup: the
    reference's float32 cosine (XLA's) is itself up to one ulp off the
    correctly rounded one the port takes, so those steps are held to one
    float32 ulp."""
    ref, port = getattr(JSCH, name)(*args), getattr(TSCH, name)(*args)
    want = np.array([np.float32(ref(jnp.int32(s))) for s in range(61)])
    got = np.array([port(s) for s in range(61)])
    assert all(isinstance(port(s), float) for s in (0, 60))
    assert np.array_equal(got.astype(np.float32).astype(np.float64), got)
    got = got.astype(np.float32)
    if name != "warmup_cosine":
        np.testing.assert_array_equal(got, want)
        return
    warm = args[1]
    np.testing.assert_array_equal(got[:warm + 1], want[:warm + 1])
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize("seed,n,S,vocab", [(0, 6, 33, 512),
                                            (3, 5, 17, 151936),
                                            (1, 2, 2, 7)])
def test_lm_tokens_bit_equal(seed, n, S, vocab):
    np.testing.assert_array_equal(TSYN.lm_tokens(seed, n, S, vocab),
                                  JSYN.lm_tokens(seed, n, S, vocab))


def _arrays():
    rng = np.random.default_rng(7)
    return {"x": rng.standard_normal((23, 3)).astype(np.float32),
            "y": rng.integers(0, 9, (23,)).astype(np.int32)}


def _ref_batches(k, **kw):
    ref = JPL.ShardedLoader(_arrays(), **kw)
    return [ref._make_batch() for _ in range(k)]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize("seed,batch", [(0, 5), (4, 8)])
def test_loader_matches_reference_make_batch_sequence(seed, batch):
    """Two epochs and more (23 rows drop the remainder of each), held to
    the reference's ``_make_batch()`` called in sequence."""
    k = 3 * (23 // batch) + 1
    _same(TPL.ShardedLoader(_arrays(), batch, seed=seed).take(k),
          _ref_batches(k, global_batch=batch, seed=seed))


def test_loader_state_resumes_at_the_first_unconsumed_batch():
    want = _ref_batches(9, global_batch=5, seed=2)
    a = TPL.ShardedLoader(_arrays(), 5, seed=2, prefetch=3)
    it = iter(a)
    first = [next(it) for _ in range(5)]
    time.sleep(0.05)  # the worker has made batches ahead by now
    state = a.state_dict()
    assert state == {"epoch": 1, "pos": 5, "seed": 2}
    it.close()
    b = TPL.ShardedLoader(_arrays(), 5, seed=0)
    b.load_state_dict(state)
    _same(first + b.take(4), want)
    # a closed iterator's made-ahead batches are made again
    _same(first + a.take(4), want)


def test_loader_hands_out_every_batch_to_a_slow_consumer():
    """The reference's worker drops a batch whenever its queue stays full
    for 0.5 s and counts it as consumed; the port's never does (ROADMAP
    C.5)."""
    a = TPL.ShardedLoader(_arrays(), 4, seed=1, prefetch=1)
    got = []
    for batch in a:
        got.append(batch)
        if len(got) == 4:
            break
        time.sleep(0.6)
    _same(got, _ref_batches(4, global_batch=4, seed=1))
    assert a.state_dict()["pos"] == 16


def test_loader_hands_a_failure_to_the_consumer():
    arrays = dict(_arrays(), y=np.zeros(10, np.int32))  # rows that are not
    with pytest.raises(IndexError):
        TPL.ShardedLoader(arrays, 8, seed=0).take(2)


def _decisions(mon, series):
    return [(d.action.value, d.host, d.reason) for d in
            (mon.record(*x) for x in series)]


@pytest.mark.parametrize("case", ["persistent", "uniform", "transient"])
def test_straggler_monitor_matches_reference(case):
    rng = np.random.default_rng(0)
    series = []
    for step in range(40):
        t = rng.normal(1.0, 0.02, 4)
        if case == "persistent" and step >= 10:
            t[2] += 2.0
        if case == "transient" and step in (12, 20, 21):
            t[1] += 1.5
        series.append((t,))
    kw = dict(n_hosts=4, patience=3, warmup=5)
    got = _decisions(TST.StragglerMonitor(**kw), series)
    assert got == _decisions(JST.StragglerMonitor(**kw), series)
    assert any(a != "none" for a, _, _ in got) == (case != "uniform")


@pytest.mark.parametrize("skewed", [True, False])
def test_token_skew_monitor_matches_reference(skewed):
    rng = np.random.default_rng(1)
    series = []
    for _ in range(60):
        tok = rng.integers(900, 1100, 4).astype(np.float64)
        if skewed:
            tok[3] *= 1.6
        series.append((tok / 1000 + rng.normal(0, 0.01, 4), tok))
    got = _decisions(TST.TokenSkewMonitor(window=20), series)
    assert got == _decisions(JST.TokenSkewMonitor(window=20), series)
    assert (got[-1][0] == "rebalance") == skewed


def test_train_loop_resumes_into_an_uninterrupted_run(tmp_path):
    """4 steps with a save at step 2 and the final save at 4, then a
    restart for 2 more: the same losses, params and moments as 6 steps in
    one run (bit for bit on the CPU), the loader at the next unconsumed
    batch across an epoch; and the losses those of the reference's step
    fed the same batches (the loader's deterministic sequence) from the
    same init."""
    spec = TC.smoke_variant(TC.get_arch("qwen2-1.5b"))
    kw = dict(device="cpu", n_data=16, log_every=0, seed=3)
    whole = TTR.train_loop(spec, "smoke_train", steps=6, **kw)
    first = TTR.train_loop(spec, "smoke_train", steps=4, save_interval=2,
                           ckpt_dir=str(tmp_path), **kw)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000002", "step_0000000004"]
    rest = TTR.train_loop(spec, "smoke_train", steps=2, save_interval=2,
                          ckpt_dir=str(tmp_path), **kw)
    assert rest["final_step"] == 6
    assert first["losses"] + rest["losses"] == whole["losses"]
    assert rest["opt_state"].step == whole["opt_state"].step == 6
    for a, b in ((rest["params"], whole["params"]),
                 (rest["opt_state"].m, whole["opt_state"].m),
                 (rest["opt_state"].v, whole["opt_state"].v)):
        assert max(leaf_errs(a, to_np(b)).values()) == 0.0
    man = Checkpointer(str(tmp_path)).restore({"params": whole["params"]})[1]
    # 4 batches of 4 an epoch of 16 rows: 6 batches end at epoch 1, row 8
    assert man["step"] == 6 and man["meta"]["loader"] == {
        "epoch": 1, "pos": 8, "seed": 3}

    # the reference's step on the loader's batch sequence, same init
    ref = JC.smoke_variant(JC.get_arch("qwen2-1.5b"))
    init = jax.tree.map(jnp.asarray, to_np(TTR.init_params(spec, 3, "cpu")))
    data = TTR.make_train_data(spec, spec.shape("smoke_train"), 16, 3)
    np.testing.assert_array_equal(
        data["tokens"], JSYN.lm_tokens(3, 16, 33, 512)[:, :-1])
    loader = JPL.ShardedLoader(data, 4, seed=3)
    metrics, _, _ = ref_run(ref, ref.shape("smoke_train"), init,
                            [loader._make_batch() for _ in range(6)])
    np.testing.assert_allclose(whole["losses"],
                               [m["loss"] for m in metrics], rtol=1e-4)


def test_train_loop_mem_family_runs(tmp_path):
    spec = TC.smoke_variant(TC.get_arch("recall-imagebind"))
    out = TTR.train_loop(spec, TC.ShapeConfig("t", "train", global_batch=8),
                         device="cpu", steps=2, n_data=16, log_every=0,
                         ckpt_dir=str(tmp_path))
    assert out["final_step"] == 2 and np.isfinite(out["losses"]).all()
    assert out["params"]["logit_scale"].dtype == torch.bfloat16


def test_train_cli_runs(capsys):
    TTR.main(["--arch", "qwen2-1.5b", "--smoke", "--steps", "3",
              "--device", "cpu", "--n-data", "16"])
    assert "final loss" in capsys.readouterr().out


def test_train_entry_points_refuse_what_is_not_there():
    spec = TC.smoke_variant(TC.get_arch("qwen2-1.5b"))
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TTR.train_loop(spec, "smoke_train", steps=1)
    # every family of the reference trains but gnn, whose data the
    # reference's make_train_data refuses too (test_torch_families_steps);
    # a family it does not know raises ValueError
    other = TC.ArchSpec("x", "other", spec.model, spec.shapes)
    with pytest.raises(ValueError, match="other"):
        TTR.train_loop(other, "smoke_train", device="cpu", steps=1)
    with pytest.raises(ValueError, match="other"):
        TTR.make_train_data(other, spec.shape("smoke_train"), 4)
    with pytest.raises(ValueError, match="other"):
        TTR.init_params(other, 0, "cpu")
