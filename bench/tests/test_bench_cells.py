"""Whole runs of each cell at tiny size on the CPU, past the harness's look
for a card: the result line is the contract's object and the sound run
is correct; the control (the reference at the step below the stated
precision, in the program's place) reads well above the sound run; and a
run whose timed path is broken underneath comes out not correct."""
import json

import numpy as np
import pytest
import torch

from bench import harness
from bench.tests import tiny

CELLS = ["recall.embed", "qwen2.prefill_16k", "qwen2.prefill_2k"]


@pytest.fixture(autouse=True)
def _one_thread():
    """The suite runs in several worker processes at once: one torch
    thread each while these tests run (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line_is_the_contracts_object(cell, trace, capsys):
    _, out = tiny.measure(cell, seed=2 ** 31 + 17, trace=trace)
    harness.print_result(out)
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    names = set(line["metrics"])
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in harness.metrics_of(tiny.BENCH, cell, kind)}
    assert names <= want
    if not trace:
        assert names == want and "setup_s" in names
    else:   # on the CPU only the program's counters and spans read
        assert not any("roofline" in n or "idle" in n for n in names)
    err = captured.err.strip().splitlines()
    assert all(ln.startswith("check ") for ln in err[-len(line["checks"]):])


def _inputs(drv):
    """The inputs a driver made in set-up: its weights and its requests."""
    if hasattr(drv, "photos"):
        return [drv.params["towers"]["vision"]["layers"]["attn"]["wq"],
                drv.photos, torch.as_tensor(drv.order)]
    return [drv.params["embed"], drv.prompts]


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_inputs(cell):
    a, b = tiny.driver(cell, seed=9), tiny.driver(cell, seed=9)
    for d in (a, b):
        d.setup()
    for x, y in zip(_inputs(a), _inputs(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("cell", CELLS)
def test_another_seed_other_inputs(cell):
    """Every input is drawn from ``--seed``: weights and requests differ
    between two large seeds."""
    a = tiny.driver(cell, seed=2 ** 31 + 5)
    b = tiny.driver(cell, seed=2 ** 31 + 6)
    for d in (a, b):
        d.setup()
    for x, y in zip(_inputs(a), _inputs(b)):
        assert x.shape == y.shape and not torch.equal(x, y)


SEPARATES = {"recall.embed": ["act_gap"],
             "qwen2.prefill_2k": ["kv_err", "exit_err"]}


@pytest.mark.parametrize("cell", sorted(SEPARATES))
def test_control_reads_well_above_the_sound_run(cell):
    drv, out = tiny.measure(cell, seed=3)
    sound = {k: c["value"] for k, c in out["checks"].items()}
    with torch.no_grad():
        ctl = drv.judge(drv.standin(drv.control_prec()))
    for k in SEPARATES[cell]:
        assert ctl[k] > 3 * sound[k] and ctl[k] > 0, (k, sound[k], ctl[k])
    assert any(ctl[k] > out["checks"][k]["limit"] for k in SEPARATES[cell])


def _broken(monkeypatch, fault):
    """Plant ``fault`` in the program underneath the timed path."""
    from repro_torch.core.store import EmbeddingStore
    from repro_torch.launch import steps
    if fault in ("drop_half", "alter_row"):
        add = EmbeddingStore.add_batch

        def add_batch(self, uids, embs, exit_idxs, exit_layers, **kw):
            uids, embs = np.asarray(uids), np.array(embs, np.float32)
            if fault == "drop_half":
                n = (len(uids) + 1) // 2
                kw["cached_hs"] = kw["cached_hs"][:n]
                return add(self, uids[:n], embs[:n], exit_idxs[:n],
                           exit_layers[:n], **kw)
            embs[0] = -embs[0]
            return add(self, uids, embs, exit_idxs, exit_layers, **kw)
        monkeypatch.setattr(EmbeddingStore, "add_batch", add_batch)
    else:
        build = steps.build_lm_prefill

        def build_lm_prefill(*a, **kw):
            bundle = build(*a, **kw)
            fn = bundle.fn

            def step(params, tokens):
                out = fn(params, tokens)
                B = tokens.shape[0]
                if fault == "state_unchanged":
                    out["k_cache"].zero_()
                    out["v_cache"].zero_()
                elif fault == "half_batch":
                    out["k_cache"][:, B // 2:] = 0
                    out["v_cache"][:, B // 2:] = 0
                    out["exit_embs"][:, B // 2:] = 0
                else:
                    out["exit_embs"][0, 0] = -out["exit_embs"][0, 0]
                return out
            bundle.fn = step
            return bundle
        monkeypatch.setattr(steps, "build_lm_prefill", build_lm_prefill)


@pytest.mark.parametrize("cell,fault", [
    ("recall.embed", "drop_half"), ("recall.embed", "alter_row"),
    ("qwen2.prefill_2k", "state_unchanged"),
    ("qwen2.prefill_2k", "half_batch"),
    ("qwen2.prefill_16k", "alter_exit")])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    _broken(monkeypatch, fault)
    _, out = tiny.measure(cell, seed=4)
    assert out["correct"] is False, out["checks"]
