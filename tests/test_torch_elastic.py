"""Port parity: ``repro_torch.distributed.elastic`` and the checkpointer's
sharded save and restore. ``validate_divisibility``'s strings and
``survivors_mesh``'s shapes and error against the reference;
``elastic_restore`` from a (4, 2) mesh onto (2, 2) against the reference's
per-device shards on its test's inputs (computed in one subprocess on 8
host devices); the LM loss of params placed on a (4, 2) mesh against the
reference's single-device loss; a sharded save's files against an
unsharded one's."""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType

from repro.configs import base as JC
from repro.distributed import elastic as JE
from repro.distributed import mesh_utils as JM
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro_torch.checkpoint.checkpointer import Checkpointer, CheckpointManager
from repro_torch.configs import base as TC
from repro_torch.distributed import elastic as TE
from repro_torch.distributed import mesh_utils as TM
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# the reference test's tree plus leaves of other ranks and rules
SPECS = {"w": ("embed", "mlp"), "b": ("mlp",),
         "k": ("layer", "embed", "kv_heads", "head_dim"), "s": ()}
SHAPES = {"w": (8, 8), "b": (8,), "k": (2, 8, 2, 4), "s": ()}

REF = """
import sys, tempfile
import jax, jax.numpy as jnp, numpy as np
from repro.checkpoint.checkpointer import Checkpointer
from repro.distributed import mesh_utils
from repro.distributed.elastic import elastic_restore, survivors_mesh

SPECS = %r
SHAPES = %r
out = {}
tree = {k: jnp.arange(float(np.prod(s))).reshape(s) for k, s in SHAPES.items()}
with tempfile.TemporaryDirectory() as d:
    ck = Checkpointer(d)
    mesh_a = jax.make_mesh((4, 2), ("data", "model"))
    rules = mesh_utils.lm_rules(False)
    sh = mesh_utils.make_shardings(SPECS, mesh_a, rules)
    placed = jax.tree.map(lambda x, s: jax.device_put(x, s), tree, sh)
    ck.save(10, placed)
    mesh_b = jax.make_mesh((2, 2), ("data", "model"),
                           devices=jax.devices()[:4])
    restored, man = elastic_restore(ck, tree, mesh_b, rules, SPECS)
    assert man["step"] == 10
    order = list(mesh_b.devices.flat)
    for k, arr in restored.items():
        by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        for i, dev in enumerate(order):
            out[f"{k}/{i}"] = by_dev[dev]
        out[f"{k}/logical"] = np.asarray(arr)
devs = jax.devices()
for i, (n, shape, axes, failed) in enumerate(%r):
    try:
        m = survivors_mesh(devs[:n], shape, axes, failed=failed)
        out[f"surv/{i}"] = np.asarray([m.shape[a] for a in axes])
    except RuntimeError as e:
        out[f"surv/{i}/error"] = np.asarray(str(e))
np.savez(sys.argv[1], **out)
"""

SURVIVOR_CASES = [
    (8, (4, 2), ("data", "model"), 2), (8, (4, 2), ("data", "model"), 0),
    (8, (2, 2, 2), ("pod", "data", "model"), 1),
    (8, (2, 2, 2), ("pod", "data", "model"), 3),
    (8, (1, 8), ("data", "model"), 1), (6, (3, 2), ("data", "model"), 1),
    (8, (2, 4), ("model", "data"), 5), (4, (2, 2), ("data", "model"), 2)]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("elastic") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    code = textwrap.dedent(REF) % (SPECS, SHAPES, SURVIVOR_CASES)
    out = subprocess.run([sys.executable, "-c", code, str(path)],
                         capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr
    return dict(np.load(path))


def _tree():
    return {k: torch.arange(float(np.prod(s))).reshape(s)
            for k, s in SHAPES.items()}


def test_elastic_restore_matches_reference_shards(ref, tmp_path):
    rules = TM.lm_rules(False)
    mesh_a = make_mesh((4, 2), ("data", "model"), ["cpu"] * 8)
    placed = TM.place_tree(_tree(), TM.make_shardings(SPECS, mesh_a, rules))
    ck = Checkpointer(str(tmp_path))
    ck.save(10, placed)
    mesh_b = TE.survivors_mesh(["cpu"] * 8, (4, 2), ("data", "model"),
                               failed=4)
    assert mesh_b.shape == {"data": 2, "model": 2}
    restored, man = TE.elastic_restore(ck, _tree(), mesh_b, rules, SPECS)
    assert man["step"] == 10
    for k, st in restored.items():
        assert isinstance(st, TM.ShardedTensor)
        assert st.sharding.mesh is mesh_b
        assert len(st.pieces) == 4
        for i, piece in enumerate(st.pieces):
            np.testing.assert_array_equal(piece.numpy(), ref[f"{k}/{i}"])
        assert torch.equal(st.gather(), _tree()[k])
        np.testing.assert_array_equal(st.gather().numpy(), ref[f"{k}/logical"])


@pytest.mark.parametrize("i", range(len(SURVIVOR_CASES)))
def test_survivors_mesh_matches_reference(ref, i):
    n, shape, axes, failed = SURVIVOR_CASES[i]
    devices = [f"cpu:{j}" for j in range(n)]
    if f"surv/{i}/error" in ref:
        with pytest.raises(RuntimeError) as e:
            TE.survivors_mesh(devices, shape, axes, failed=failed)
        assert str(e.value) == str(ref[f"surv/{i}/error"])
        return
    m = TE.survivors_mesh(devices, shape, axes, failed=failed)
    assert [m.shape[a] for a in axes] == list(ref[f"surv/{i}"])
    assert m.axis_names == axes
    assert [str(d) for d in m.device_list] == devices[:m.size]


def _jmesh(shape, axes):
    return AbstractMesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


@pytest.mark.parametrize("arch,mesh,with_opt", [
    ("qwen2-1.5b", ((1, 16), ("data", "model")), False),
    ("qwen3-moe-30b-a3b", ((2, 16, 16), ("pod", "data", "model")), False),
    ("deepseek-67b", ((16, 16), ("data", "model")), True),
    ("minitron-8b", ((3, 5), ("data", "model")), True)])
def test_validate_divisibility_strings_match_reference(arch, mesh, with_opt):
    shape, axes = mesh
    jspec, tspec = JC.get_arch(arch), TC.get_arch(arch)
    multi_pod = "pod" in axes
    rules = JM.lm_rules(multi_pod)
    jm, tm = _jmesh(shape, axes), make_mesh(shape, axes,
                                            ["meta"] * int(np.prod(shape)))
    j_ab = JT.lm_abstract(jspec.model, jspec.recall)
    t_ab = TT.lm_abstract(tspec.model, tspec.recall)
    j_sh = JM.make_shardings(JT.lm_specs(jspec.model, jspec.recall), jm, rules)
    t_sh = TM.make_shardings(TT.lm_specs(tspec.model, tspec.recall), tm, rules)
    if with_opt:
        j_opt = JS._opt_state_abstract(JS._opt(), j_ab)
        t_opt = TS._opt().init(t_ab)
        j_ab, t_ab = {"opt": j_opt, "params": j_ab}, {"opt": t_opt,
                                                      "params": t_ab}
        j_sh = {"opt": JS._opt_state_shardings(jm, j_sh, j_opt),
                "params": j_sh}
        t_sh = {"opt": TS._opt_state_shardings(tm, t_sh, t_opt),
                "params": t_sh}
    want = JE.validate_divisibility(j_ab, j_sh)
    got = TE.validate_divisibility(t_ab, t_sh)
    assert got == want
    assert want or shape == (3, 5) or arch != "qwen2-1.5b"


def test_placed_gathered_lm_loss_matches_single_device():
    """test_distributed.py's inputs: the reference's single-device loss
    against the port's loss of params placed on a (4, 2) mesh and gathered
    back (place -> gather -> loss: the port's step runs on one device)."""
    from repro.configs.base import LMConfig, RecallConfig
    from repro_torch.configs.base import LMConfig as TLMConfig
    from repro_torch.configs.base import RecallConfig as TRecallConfig
    kw = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
              vocab=64, d_head=8, dtype="float32")
    cfg, rc = LMConfig(**kw), RecallConfig(exit_interval=1,
                                           superficial_layers=1)
    tcfg, trc = TLMConfig(**kw), TRecallConfig(exit_interval=1,
                                               superficial_layers=1)
    params = JT.lm_init(jax.random.PRNGKey(0), cfg, rc, embed_out=16)
    toks = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, 64)
    labels = jnp.roll(toks, -1, 1)
    ref = float(JT.lm_loss(params, cfg, rc, toks, labels, block_q=8,
                           block_kv=8, chunk=8)[0])

    tparams = params_from_jax(jax.tree.map(np.asarray, params))
    mesh = make_mesh((4, 2), ("data", "model"), ["cpu"] * 8)
    rules = TM.lm_rules(False)
    sh = TM.make_shardings(TT.lm_specs(tcfg, trc, embed_out=16), mesh, rules,
                           abstract_tree=TT.lm_abstract(tcfg, trc,
                                                        embed_out=16))
    placed = TM.place_tree(tparams, sh)
    got = float(TT.lm_loss(TM.gather_tree(placed, "cpu"), tcfg, trc,
                           torch.from_numpy(np.asarray(toks)),
                           torch.from_numpy(np.asarray(labels)),
                           chunk=8)[0])
    assert abs(ref - got) < 1e-4, (ref, got)


def _files(d):
    step = sorted(os.listdir(d))[0]
    out = {}
    for fn in sorted(os.listdir(os.path.join(d, step))):
        p = os.path.join(d, step, fn)
        if fn == "manifest.json":
            man = json.load(open(p))
            man.pop("time")
            out[fn] = man
        else:
            out[fn] = open(p, "rb").read()
    return out


def test_sharded_save_writes_the_unsharded_files(tmp_path):
    from repro_torch.optim.adamw import AdamWState
    g = torch.Generator().manual_seed(0)
    tree = {"params": {"w": torch.randn((8, 6), generator=g).bfloat16(),
                       "v": torch.randn(12, generator=g)},
            "opt": AdamWState(step=7, m={"w": torch.randn((8, 6), generator=g)},
                              v={"w": torch.zeros(8, 6)})}
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    S = lambda *p: TM.NamedSharding(mesh, p)
    shs = {"params": {"w": S("data", "model"), "v": S(("model", "data"))},
           "opt": AdamWState(step=TM.replicated(mesh), m={"w": S(None, "data")},
                             v={"w": S()})}
    placed = TM.place_tree(tree, shs)
    Checkpointer(str(tmp_path / "a")).save(3, placed, meta={"m": 1})
    Checkpointer(str(tmp_path / "b")).save(3, tree, meta={"m": 1})
    assert _files(tmp_path / "a") == _files(tmp_path / "b")
    # restore onto another mesh through the manager, shardings passed on
    mgr = CheckpointManager(str(tmp_path / "a"))
    mesh2 = make_mesh((4,), ("data",), ["cpu"] * 4)
    shs2 = {"params": {"w": TM.NamedSharding(mesh2, ("data",)),
                       "v": TM.replicated(mesh2)},
            "opt": AdamWState(step=TM.replicated(mesh2),
                              m={"w": TM.replicated(mesh2)},
                              v={"w": TM.NamedSharding(mesh2, (None, None))})}
    back, man = mgr.restore_or_none(tree, shardings=shs2)
    assert man["step"] == 3 and back["opt"].step == 7
    assert isinstance(back["params"]["w"], TM.ShardedTensor)
    assert [tuple(p.shape) for p in back["params"]["w"].pieces] == [(2, 6)] * 4
    gathered = TM.gather_tree(back, "cpu")
    assert torch.equal(gathered["params"]["w"], tree["params"]["w"])
    assert gathered["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(gathered["opt"].m["w"], tree["opt"].m["w"])
