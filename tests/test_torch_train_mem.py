"""Port parity: RECALL's MEM training path (``imagebind.mem_contrastive_loss``
with remat, ``launch.steps.build_mem_step``'s train, serve and retrieval
kinds, ``core.exits.retrieval_at_k``) against the reference on
recall-imagebind's smoke variant (all four towers) in fp32, attention at
fan-in d (``torch_train_common``'s docstring says why); and the port's
example ``examples/train_recall_mem_torch.py`` end to end."""
import importlib.util
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JC
from repro.core import exits as JEX
from repro.data import synthetic as JSYN
from repro.distributed.mesh_utils import sharding_ctx
from repro.launch import steps as JS
from repro.models import imagebind as JIB
from repro_torch.configs import base as TC
from repro_torch.core import exits as TEX
from repro_torch.launch import steps as TS
from repro_torch.models import imagebind as TIB
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import value_and_grad
from torch_train_common import (torch_threads,  # noqa: F401 (autouse)
                                assert_leaves, check_steps, fan_in_d, fp32,
                                mesh11, port_run, ref_run, to_np)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def mem_pair():
    """recall-imagebind's smoke variant in fp32 (the smoke variant keeps
    the config's bf16)."""
    ref = fp32(JC.smoke_variant(JC.get_arch("recall-imagebind")))
    port = fp32(TC.smoke_variant(TC.get_arch("recall-imagebind")))
    init = jax.jit(partial(JIB.mem_init, cfg=ref.model, recall=ref.recall))
    return ref, port, fan_in_d(init(jax.random.PRNGKey(0)))


def test_mem_contrastive_loss_value_and_grad_match_reference(mem_pair):
    ref, port, p = mem_pair
    items = JSYN.multimodal_pairs(0, 6, ref.model).items
    jl, jg = jax.jit(jax.value_and_grad(lambda q: JIB.mem_contrastive_loss(
        q, ref.model, ref.recall, {k: jnp.asarray(v)
                                   for k, v in items.items()})[0]))(p)
    batch = {k: torch.as_tensor(v) for k, v in items.items()}
    tl, tg = value_and_grad(lambda q, b: TIB.mem_contrastive_loss(
        q, port.model, port.recall, b, remat=True)[0],
        params_from_jax(to_np(p)), batch)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert_leaves(tg, to_np(jg), 1e-5, "mem_contrastive_loss gradient")
    with torch.no_grad():
        _, tm = TIB.mem_contrastive_loss(params_from_jax(to_np(p)),
                                         port.model, port.recall, batch)
    assert sorted(tm) == ["nce_audio", "nce_imu", "nce_text"]


def test_mem_train_step_matches_reference(mem_pair):
    """Two steps of the contrastive step (batch 8, remat)."""
    ref, port, p = mem_pair
    jshape = JC.ShapeConfig("t", "train", global_batch=8)
    data = JSYN.multimodal_pairs(0, 16, ref.model).items
    batches = [{k: v[i * 8:(i + 1) * 8] for k, v in data.items()}
               for i in range(2)]
    want = ref_run(ref, jshape, p, batches)
    bundle = TS.build_step(port, TC.ShapeConfig("t", "train",
                                                global_batch=8),
                           device="cpu")
    assert bundle.meta["remat"] and bundle.meta["items"] == 8
    check_steps(port_run(bundle, params_from_jax(to_np(p)), batches), want)
    assert bundle.model_flops == JS.build_step(ref, jshape,
                                               mesh11()).model_flops


def test_mem_serve_and_retrieval_steps_match_reference(mem_pair):
    ref, port, p = mem_pair
    tp = params_from_jax(to_np(p))
    items = JSYN.multimodal_pairs(1, 4, ref.model).items
    mesh = mesh11()
    js = JS.build_step(ref, JC.ShapeConfig("s", "serve", global_batch=4),
                       mesh)
    ts = TS.build_step(port, TC.ShapeConfig("s", "serve", global_batch=4),
                       device="cpu")
    with sharding_ctx(mesh, js.rules):
        want = np.asarray(js.fn(p, jnp.asarray(items["vision"])))
    with torch.no_grad():
        got = ts.fn(tp, torch.as_tensor(items["vision"])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert ts.model_flops == js.model_flops
    bank = np.random.default_rng(2).standard_normal(
        (50, ref.model.embed_dim)).astype(np.float32)
    jr = JS.build_step(ref, JC.ShapeConfig("r", "retrieval", global_batch=4,
                                           n_candidates=50), mesh)
    tr = TS.build_step(port, TC.ShapeConfig("r", "retrieval", global_batch=4,
                                            n_candidates=50), device="cpu")
    with sharding_ctx(mesh, jr.rules):
        jv, ji = jr.fn(p, jnp.asarray(items["text"]), jnp.asarray(bank))
    with torch.no_grad():
        tv, ti = tr.fn(tp, torch.as_tensor(items["text"]),
                       torch.as_tensor(bank))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tr.model_flops == jr.model_flops


def test_retrieval_at_k_matches_reference_ties_to_lower_index():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((9, 8)).astype(np.float32)
    c = rng.standard_normal((12, 8)).astype(np.float32)
    c[5] = c[2]  # tied rows: the lower index takes the slot
    q[0] = c[2]
    targets = rng.integers(0, 12, 9).astype(np.int32)
    targets[0] = 5
    for k in (1, 2, 5):
        want = float(JEX.retrieval_at_k(jnp.asarray(q), jnp.asarray(c),
                                        jnp.asarray(targets), k=k))
        got = float(TEX.retrieval_at_k(torch.as_tensor(q),
                                       torch.as_tensor(c),
                                       torch.as_tensor(targets), k=k))
        assert got == want, k
    assert float(TEX.retrieval_at_k(torch.as_tensor(q[:1]),
                                    torch.as_tensor(c),
                                    torch.as_tensor(targets[:1]), k=1)) == 0


def test_example_runs_to_its_end(tmp_path, capsys):
    """``--preset tiny --steps 4 --batch 8 --device cpu``: pretraining,
    healing, the pre-exit predictor, R@1 at each stage; the final save on
    disk."""
    spec = importlib.util.spec_from_file_location(
        "train_recall_mem_torch",
        ROOT / "examples" / "train_recall_mem_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--preset", "tiny", "--steps", "4", "--batch", "8",
                    "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert text.count("R@1") == 2 and "done" in text
    assert 0 <= out["stats"]["acc"] <= 1 and out["lora"]
    assert (tmp_path / "step_0000000004" / "manifest.json").exists()
