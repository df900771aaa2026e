"""Port parity: the edge-device cost model of ``core.scheduler`` (device
profiles, per-layer costs, the five policies) against the reference's,
field for field with ``==``: both run the same numpy arithmetic in the same
order on the host. The two edge-simulation examples print the same
table."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import scheduler as JS
from repro_torch.core import scheduler as TS

ROOT = Path(__file__).resolve().parents[1]
POLICIES = ("mem", "mem_batched", "branchynet", "fluid", "recall")


def _exits(seed, n=96, L=32):
    rng = np.random.default_rng(seed)
    conf = np.clip(rng.normal(21.4, 4, n).astype(int), 8, L)
    rec = np.clip(rng.gamma(2.0, 4.0, n).astype(int) + 2, 2, L)
    return conf, rec


def _same(port, ref):
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_device_profiles_match_reference():
    assert list(TS.DEVICES) == list(JS.DEVICES) == ["ORIN", "RPI4B", "8GEN3"]
    for name in JS.DEVICES:
        _same(TS.DEVICES[name], JS.DEVICES[name])
    for a, b in ((TS.ORIN, JS.ORIN), (TS.RPI4B, JS.RPI4B),
                 (TS.GEN3, JS.GEN3)):
        _same(a, b)


# recall-imagebind's vision tower (ImageBind-huge) and text tower, and
# qwen2-1.5b's decoder
@pytest.mark.parametrize("d,ff,L,seq", [(1280, 5120, 32, 257),
                                        (1024, 4096, 24, 77),
                                        (1536, 8960, 28, 2048)])
def test_layer_flops_and_model_cost_match_reference(d, ff, L, seq):
    assert TS.transformer_layer_flops(d, ff, seq) == \
        JS.transformer_layer_flops(d, ff, seq)
    assert TS.transformer_layer_flops(d, ff, seq, ff_mult=2) == \
        JS.transformer_layer_flops(d, ff, seq, ff_mult=2)
    for kw in ({}, {"bytes_per_param": 0.5, "embed_out": 768}):
        _same(TS.model_cost_from_tower(d, ff, L, seq, **kw),
              JS.model_cost_from_tower(d, ff, L, seq, **kw))


def test_batch_eff_matches_reference():
    for b in (1, 2, 7, 8, 32, 1000):
        for half in (2.0, 0.5):
            assert TS.batch_eff(b, half) == JS.batch_eff(b, half)
    arr = np.array([1, 3, 9], np.int64)
    np.testing.assert_array_equal(TS.batch_eff(arr), JS.batch_eff(arr))


@pytest.mark.parametrize("dev", list(JS.DEVICES))
@pytest.mark.parametrize("layerwise", [True, False])
def test_every_policy_matches_reference(dev, layerwise):
    jc = JS.model_cost_from_tower(1280, 5120, 32, 257)
    tc = TS.model_cost_from_tower(1280, 5120, 32, 257)
    conf, rec = _exits(0)
    pred = np.minimum(rec + 3, 32)
    for policy in POLICIES:
        for batch, items in ((32, conf), (7, rec), (32, rec[:5])):
            for predicted in (None, pred[:len(items)]):
                kw = dict(batch=batch, layerwise=layerwise,
                          superficial_layers=7, predicted_exits=predicted)
                _same(TS.simulate_policy(policy, TS.DEVICES[dev], tc, items,
                                         **kw),
                      JS.simulate_policy(policy, JS.DEVICES[dev], jc, items,
                                         **kw))


@pytest.mark.parametrize("layerwise", [True, False])
def test_simulate_all_matches_reference(layerwise):
    conf, rec = _exits(1, n=828)
    for dev in JS.DEVICES:
        for batch, sup in ((32, 7), (8, 3)):
            want = JS.simulate_all(JS.DEVICES[dev],
                                   JS.model_cost_from_tower(1280, 5120, 32,
                                                            257),
                                   conf, rec, batch=batch,
                                   layerwise=layerwise,
                                   superficial_layers=sup)
            got = TS.simulate_all(TS.DEVICES[dev],
                                  TS.model_cost_from_tower(1280, 5120, 32,
                                                           257),
                                  conf, rec, batch=batch,
                                  layerwise=layerwise,
                                  superficial_layers=sup)
            assert list(got) == list(want) == list(POLICIES)
            for p in POLICIES:
                _same(got[p], want[p])


def test_unknown_policy_raises_as_the_reference():
    cost = TS.model_cost_from_tower(64, 128, 4, 8)
    with pytest.raises(ValueError, match="lazy"):
        TS.simulate_policy("lazy", TS.ORIN, cost, np.full(3, 4))
    with pytest.raises(ValueError, match="lazy"):
        JS.simulate_policy("lazy", JS.ORIN,
                           JS.model_cost_from_tower(64, 128, 4, 8),
                           np.full(3, 4))


def test_edge_simulation_examples_print_the_same_table():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    outs = [subprocess.run([sys.executable, str(ROOT / "examples" / name)],
                           capture_output=True, text=True, env=env,
                           check=True, timeout=120).stdout
            for name in ("edge_simulation.py", "edge_simulation_torch.py")]
    assert outs[0] == outs[1]
    rows = [line.split()[:2] for line in outs[1].splitlines()]
    assert [r for r in rows if r[1:] == ["recall"]] == [
        ["ORIN", "recall"], ["RPI4B", "recall"], ["8GEN3", "recall"]]
