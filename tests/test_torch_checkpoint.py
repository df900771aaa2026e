"""Port parity: ``repro_torch.checkpoint.checkpointer`` (the cases of
tests/test_optim_checkpoint.py, on tensors), the reference's on-disk
layout, and the leaves numpy cannot hold: bf16 tensors and the Python-int
``AdamWState.step``."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.checkpoint.checkpointer import Checkpointer, CheckpointManager
from repro_torch.optim.adamw import AdamW, AdamWState


def _tree():
    return {"a": torch.arange(6.0), "b": {"c": torch.ones((2, 3))}}


def test_roundtrip_retention_async(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = _tree()
    for s in (1, 2, 3):
        ck.save(s, {"a": tree["a"] * s, "b": {"c": tree["b"]["c"] * s}},
                meta={"s": s})
    assert ck.all_steps() == [2, 3]
    r, man = ck.restore(tree)
    assert torch.equal(r["a"], torch.arange(6.0) * 3)
    assert torch.equal(r["b"]["c"], torch.full((2, 3), 3.0))
    assert man["meta"]["s"] == 3 and man["step"] == 3
    r2, _ = ck.restore(tree, step=2)
    assert torch.equal(r2["a"], torch.arange(6.0) * 2)
    fut = ck.save_async(4, tree)
    ck.wait()
    assert fut.done() and ck.latest_step() == 4


def test_async_save_snapshots_at_the_call(tmp_path):
    """The leaves are copied when ``save_async`` returns: a later in-place
    write to the live tensor is not in the checkpoint."""
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    ck.save_async(1, tree)
    tree["a"].add_(100.0)
    ck.wait()
    assert torch.equal(ck.restore(tree)[0]["a"], torch.arange(6.0))


def test_tmp_dir_never_visible(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)
    ck.save(1, {"x": torch.ones(3)})
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    os.makedirs(tmp_path / "step_0000000009.tmp")  # a crashed save
    assert ck.all_steps() == [1] and ck.latest_step() == 1


def test_milestones_kept(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=1, milestone_every=10)
    for s in (5, 10, 15, 20):
        ck.save(s, {"x": torch.ones(1)})
    assert set(ck.all_steps()) == {10, 20}


def test_manager_preemption_forces_blocking_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_interval=100)
    assert not mgr.should_save(5) and not mgr.should_save(0)
    assert mgr.should_save(100)
    assert mgr.restore_or_none({"x": torch.ones(1)}) == (None, None)
    mgr.signal_preemption()
    assert mgr.should_save(5)
    mgr.save(5, {"x": torch.ones(1)})  # blocking: on disk at return
    assert mgr.ckpt.latest_step() == 5
    assert mgr.ckpt._pending == []


def test_restore_without_checkpoints_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path)).restore({"x": torch.ones(1)})


def test_bf16_leaves_and_adamw_step_round_trip_bit_exact(tmp_path):
    """bf16 leaves are stored as their bits with "dtype": "bfloat16"; the
    port's ``AdamWState.step`` (a Python int) as an int32 leaf, restored as
    an int; fp32 moments as they are."""
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.standard_normal((5, 4)),
                     dtype=torch.float32).to(torch.bfloat16)
    w[0, 0] = float("inf")
    w[0, 1] = -0.0
    w[0, 2] = 2.0 ** -133  # a bf16 subnormal
    params = {"w": w, "b": torch.zeros(4, dtype=torch.bfloat16)}
    opt = AdamW().init(params)
    opt = AdamWState(7, {"w": torch.randn(5, 4), "b": torch.randn(4)},
                     opt.v)
    ck = Checkpointer(str(tmp_path))
    ck.save(7, {"params": params, "opt": opt})
    like = {"params": {k: torch.zeros_like(v) for k, v in params.items()},
            "opt": AdamW().init(params)}
    r, man = ck.restore(like)
    assert isinstance(r["opt"], AdamWState) and r["opt"].step == 7
    assert type(r["opt"].step) is int
    for got, want in ((r["params"]["w"], w), (r["params"]["b"],
                                              params["b"]),
                      (r["opt"].m["w"], opt.m["w"])):
        assert got.dtype == want.dtype
        assert torch.equal(got.view(torch.int16) if got.dtype ==
                           torch.bfloat16 else got,
                           want.view(torch.int16) if want.dtype ==
                           torch.bfloat16 else want)
    leaves = man["leaves"]
    assert leaves["params/w"]["dtype"] == "bfloat16"
    assert leaves["opt/.step"]["dtype"] == "int32"
    assert leaves["opt/.m/w"]["dtype"] == "float32"


def test_on_disk_layout_matches_reference(tmp_path):
    """The same fp32 tree with an optimizer state saved by both packages:
    the same step directory, leaf names, files and arrays."""
    rng = np.random.default_rng(1)
    arrs = {"embed": rng.standard_normal((3, 2)).astype(np.float32),
            "layers": {"w": rng.standard_normal((2, 2)).astype(np.float32)}}
    j_params = {"embed": jnp.asarray(arrs["embed"]),
                "layers": {"w": jnp.asarray(arrs["layers"]["w"])}}
    t_params = {"embed": torch.as_tensor(arrs["embed"]),
                "layers": {"w": torch.as_tensor(arrs["layers"]["w"])}}
    JCheckpointer(str(tmp_path / "ref")).save(
        3, {"params": j_params, "opt": JAdamW().init(j_params)},
        meta={"loader": {"epoch": 0, "pos": 8, "seed": 0}})
    Checkpointer(str(tmp_path / "port")).save(
        3, {"params": t_params, "opt": AdamW().init(t_params)},
        meta={"loader": {"epoch": 0, "pos": 8, "seed": 0}})
    dirs = [tmp_path / w / "step_0000000003" for w in ("ref", "port")]
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1]))
    mans = [json.loads((d / "manifest.json").read_text()) for d in dirs]
    assert mans[0]["leaves"] == mans[1]["leaves"]
    assert mans[0]["meta"] == mans[1]["meta"]
    for name, info in mans[0]["leaves"].items():
        a, b = (np.load(d / info["file"]) for d in dirs)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_restore_places_leaves_on_the_asked_device(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"x": torch.ones(2, dtype=torch.bfloat16)})
    r, _ = ck.restore({"x": torch.zeros(2, dtype=torch.bfloat16)},
                      device="cpu")
    assert r["x"].device.type == "cpu" and r["x"].dtype == torch.bfloat16
