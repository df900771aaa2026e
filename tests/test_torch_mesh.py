"""Port parity: ``repro_torch.distributed.mesh_utils`` (the rule tables,
``logical_to_spec``, ``_drop_indivisible``, ``make_shardings``), the spec
and abstract helpers of every model family, the mesh types (``shard`` and
``gather`` bit for bit) and ``build_step(mesh=...)``'s layouts, each
against the reference on an ``AbstractMesh`` of the same shape (``Auto``
axes, which the reference's sharding code takes under jax 0.9)."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType
from jax.sharding import NamedSharding as JNamedSharding

from repro.configs import base as JC
from repro.core import plora as JP
from repro.distributed import mesh_utils as JM
from repro.launch import steps as JS
from repro.models import gnn as JG
from repro.models import imagebind as JIB
from repro.models import layers as JL
from repro.models import recsys as JR
from repro.models import transformer as JT
from repro_torch.configs import base as TC
from repro_torch.core import plora as TP
from repro_torch.distributed import mesh_utils as TM
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import gnn as TG
from repro_torch.models import imagebind as TIB
from repro_torch.models import layers as TL
from repro_torch.models import recsys as TR
from repro_torch.models import transformer as TT

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x2": ((4, 2), ("data", "model"))}


def jmesh(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


def tmesh(name, device="cpu"):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, [device] * int(np.prod(shape)))


def jspec(spec):
    """A reference PartitionSpec as a tuple without trailing Nones."""
    parts = list(spec)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _flat_port(tree, path=""):
    """{keystr-like path: leaf} of a port tree, in jax.tree_util's
    spelling (``['k']``, ``.field``, ``[i]``)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_port(tree[k], f"{path}[{k!r}]"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(_flat_port(getattr(tree, f), f"{path}.{f}"))
        return out
    if isinstance(tree, tuple) and not isinstance(tree, TM.PartitionSpec):
        out = {}
        for i, x in enumerate(tree):
            out.update(_flat_port(x, f"{path}[{i}]"))
        return out
    return {path: tree}


def _flat_ref(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JNamedSharding))
    return {jax.tree_util.keystr(p): x for p, x in flat}


def _shape_of(x):
    return tuple(x.shape) if hasattr(x, "shape") else ()


def assert_same_layout(t_sh, j_sh, t_ab, j_ab):
    """Leaf for leaf: the same paths, spec, abstract shape and shard
    shape."""
    ts, js = _flat_port(t_sh), _flat_ref(j_sh)
    ta, ja = _flat_port(t_ab), _flat_ref(j_ab)
    assert sorted(ts) == sorted(js)
    assert sorted(ta) == sorted(ja) == sorted(ts)
    for path in js:
        assert tuple(ts[path].spec) == jspec(js[path].spec), path
        shape = _shape_of(ja[path])
        assert _shape_of(ta[path]) == shape, path
        assert ts[path].shard_shape(shape) == js[path].shard_shape(shape), \
            path


# ---------------------------------------------------------------------------
# rule tables and spec arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("family,kw", [
    ("lm", {}), ("lm", {"seq_shard_kv": True}), ("lm", {"fsdp": False}),
    ("gnn", {}), ("recsys", {}), ("mem", {})])
def test_rule_tables_equal_reference(family, kw, multi_pod):
    assert TM.rules_for_family(family, multi_pod, **kw) == \
        JM.rules_for_family(family, multi_pod, **kw)
    table = {"lm": "lm_rules", "gnn": "gnn_rules", "recsys": "recsys_rules",
             "mem": "mem_rules"}[family]
    assert getattr(TM, table)(multi_pod, **kw) == \
        getattr(JM, table)(multi_pod, **kw)


def test_rules_for_unknown_family_raises():
    with pytest.raises(ValueError):
        TM.rules_for_family("other", False)


AXES_CASES = [
    ("embed", "mlp"), ("layer", "embed", "heads", "head_dim"),
    ("layer", "embed", "kv_heads", "head_dim"), ("vocab", "embed"),
    ("batch", "seq"), ("edges",), ("nodes", None), ("table_rows", "embed"),
    ("cands", "act_embed"), ("batch", "cands"), ("embed", "embed"),
    ("layer", "kv_batch", "kv_seq", "kv_heads", "head_dim"),
    ("expert", "embed", "mlp"), (None, None), (), ("unknown", "mlp")]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("family", ["lm", "gnn", "recsys", "mem"])
@pytest.mark.parametrize("axes", AXES_CASES, ids=str)
def test_logical_to_spec_equals_reference(axes, family, multi_pod):
    kw = {"seq_shard_kv": True} if family == "lm" else {}
    rules = JM.rules_for_family(family, multi_pod, **kw)
    assert tuple(TM.logical_to_spec(axes, rules)) == \
        jspec(JM.logical_to_spec(axes, rules))


SPEC_SHAPES = [
    ((None, "data"), (28, 96, 2, 128)), (("data", "model"), (8, 8)),
    ((("data", "model"),), (64,)), ((("data", "model"),), (24,)),
    ((("pod", "data", "model"),), (1024,)), ((("pod", "data"), None), (6, 3)),
    (("model", None, "data"), (2, 5, 32)), ((), (3,)),
    ((("model", "data"),), (4,))]


def _names(spec):
    return {a for p in spec if p is not None
            for a in ((p,) if isinstance(p, str) else p)}


@pytest.mark.parametrize("mesh,spec,shape", [
    (m, sp, sh) for m in ("16x16", "2x16x16", "4x2") for sp, sh in SPEC_SHAPES
    if _names(sp) <= set(MESHES[m][1])])
def test_drop_indivisible_equals_reference(mesh, spec, shape):
    want = JM._drop_indivisible(jax.sharding.PartitionSpec(*spec), shape,
                                jmesh(mesh))
    got = TM._drop_indivisible(TM.PartitionSpec(*spec), shape, tmesh(mesh))
    assert tuple(got) == jspec(want)


def test_partition_spec_drops_trailing_nones():
    assert TM.PartitionSpec("data", None, None) == ("data",)
    assert TM.PartitionSpec(None, ["data", "model"]) == (None, ("data", "model"))
    assert TM.PartitionSpec() == ()


# ---------------------------------------------------------------------------
# make_shardings over the six spec functions
# ---------------------------------------------------------------------------


def _spec_cases(arch, smoke):
    """[(what, port (specs, abstract), ref (specs, abstract), family)]."""
    jspec_ = JC.get_arch(arch)
    tspec = TC.get_arch(arch)
    if smoke:
        jspec_, tspec = JC.smoke_variant(jspec_), TC.smoke_variant(tspec)
    jm, tm, rc, trc = jspec_.model, tspec.model, jspec_.recall, tspec.recall
    fam = jspec_.family
    cases = []
    if fam == "lm":
        cases.append(("lm", (TT.lm_specs(tm, trc), TT.lm_abstract(tm, trc)),
                      (JT.lm_specs(jm, rc), JT.lm_abstract(jm, rc)), fam))
        cases.append(("lora", (TP.lora_specs(tm, trc), TL.abstract_params(
            TP.lora_schema(tm, trc))), (JP.lora_specs(jm, rc),
                                        JL.abstract_params(JP.lora_schema(jm, rc))),
            fam))
    elif fam == "mem":
        cases.append(("mem", (TIB.mem_specs(tm, trc), TL.abstract_params(
            TIB.mem_schema(tm, trc), tm.dtype)), (JIB.mem_specs(jm, rc),
                                                  JL.abstract_params(JIB.mem_schema(jm, rc),
                                                                     jax.numpy.dtype(jm.dtype))),
            fam))
    elif fam == "recsys":
        cases.append(("recsys", (TR.recsys_specs(tm), TL.abstract_params(
            TR.recsys_schema(tm), tm.dtype)), (JR.recsys_specs(jm),
                                               JL.abstract_params(JR.recsys_schema(jm),
                                                                  jax.numpy.dtype(jm.dtype))),
            fam))
    else:
        cases.append(("gnn", (TG.gnn_specs(tm, trc), TL.abstract_params(
            TG.gnn_schema(tm, trc), tm.dtype)), (JG.gnn_specs(jm, rc),
                                                 JL.abstract_params(JG.gnn_schema(jm, rc),
                                                                    jax.numpy.dtype(jm.dtype))),
            fam))
    return cases


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16", "2x2", "4x2"])
@pytest.mark.parametrize("arch", JC.list_archs())
def test_make_shardings_equal_reference(arch, mesh):
    """Full configs on the production meshes, smoke variants on (2, 2) and
    (4, 2): every leaf's spec, abstract shape and shard shape."""
    smoke = mesh in ("2x2", "4x2")
    multi_pod = mesh == "2x16x16"
    for what, (t_specs, t_ab), (j_specs, j_ab), fam in _spec_cases(arch, smoke):
        rules = JM.rules_for_family(fam, multi_pod)
        j_sh = JM.make_shardings(j_specs, jmesh(mesh), rules, abstract_tree=j_ab)
        t_sh = TM.make_shardings(t_specs, tmesh(mesh, "meta"), rules,
                                 abstract_tree=t_ab)
        assert_same_layout(t_sh, j_sh, t_ab, j_ab)
        # without an abstract tree: the logical specs, indivisible or not
        j_raw = _flat_ref(JM.make_shardings(j_specs, jmesh(mesh), rules))
        t_raw = _flat_port(TM.make_shardings(t_specs, tmesh(mesh, "meta"), rules))
        assert {p: tuple(s.spec) for p, s in t_raw.items()} == \
            {p: jspec(s.spec) for p, s in j_raw.items()}, what


def test_qwen2_kv_heads_replicate_over_the_model_axis():
    spec = TC.get_arch("qwen2-1.5b")
    ab = TT.lm_abstract(spec.model, spec.recall)
    sh = TM.make_shardings(TT.lm_specs(spec.model, spec.recall),
                           make_production_mesh(), TM.lm_rules(False), ab)
    wk = sh["layers"]["attn"]["wk"]
    assert wk.spec == (None, "data")
    assert wk.shard_shape(ab["layers"]["attn"]["wk"].shape) == (28, 96, 2, 128)
    assert ab["layers"]["attn"]["wk"].device.type == "meta"
    assert ab["layers"]["attn"]["wk"].dtype == torch.bfloat16


def test_abstract_params_match_init_params():
    """``abstract_params`` has the keys, shapes and dtype that
    ``init_params`` draws, on ``meta``."""
    spec = TC.smoke_variant(TC.get_arch("qwen3-moe-30b-a3b"))
    schema = TT.lm_schema(spec.model, spec.recall)
    real = TL.init_params(torch.Generator().manual_seed(0), schema,
                          dtype="float32", device="cpu")
    ab = TL.abstract_params(schema, "float32")
    fr, fa = _flat_port(real), _flat_port(ab)
    assert fr.keys() == fa.keys()
    assert TM.tree_map(len, TL.param_specs(schema)) == \
        TM.tree_map(lambda t: t.dim(), real)
    for k in fr:
        assert fa[k].shape == fr[k].shape and fa[k].dtype == fr[k].dtype
        assert fa[k].device.type == "meta"


# ---------------------------------------------------------------------------
# shard / gather
# ---------------------------------------------------------------------------


def _expected_piece(x, spec, mesh, idx):
    """The slice entry ``idx`` (mesh coordinates) holds, worked out
    from the layout's definition: a dim split over axes (a, b) is cut
    into size_a x size_b blocks, block coord_a * size_b + coord_b."""
    coord = dict(zip(mesh.axis_names, idx))
    parts = list(spec) + [None] * (x.ndim - len(spec))
    sl = []
    for dim, p in zip(x.shape, parts):
        axes = () if p is None else ((p,) if isinstance(p, str) else p)
        n, b = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            b = b * mesh.shape[a] + coord[a]
        sl.append(slice(b * (dim // n), (b + 1) * (dim // n)))
    return x[tuple(sl)]


@pytest.mark.parametrize("shape,axes,spec", [
    ((2,), ("data",), ("data",)),
    ((4, 2), ("data", "model"), ("data", "model")),
    ((4, 2), ("data", "model"), (("data", "model"),)),
    ((4, 2), ("data", "model"), (("model", "data"), None)),
    ((4, 2), ("data", "model"), (None, "data")),
    ((2, 2, 2), ("pod", "data", "model"), (("pod", "data"), "model")),
    ((2, 2, 2), ("pod", "data", "model"), ()),
    ((8,), ("seq",), (None, None, "seq")),
    ((3, 2), ("data", "model"), ("model", None, "data"))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_shard_and_gather_bit_for_bit(shape, axes, spec, dtype):
    n = int(np.prod(shape))
    mesh = make_mesh(shape, axes, ["cpu"] * n)
    sh = TM.NamedSharding(mesh, spec)
    g = torch.Generator().manual_seed(n)
    x = (torch.randn((48, 6, 24), generator=g) * 100).to(dtype)
    if len(spec) < 3:
        x = x[:, 0]
    pieces = sh.shard(x)
    assert len(pieces) == n
    for idx, piece in zip(np.ndindex(shape), pieces):
        want = _expected_piece(x, sh.spec, mesh, idx)
        assert tuple(piece.shape) == sh.shard_shape(x.shape)
        assert torch.equal(piece, want)
        assert piece.data_ptr() != x.data_ptr() or piece.numel() == 0
    st = TM.ShardedTensor.place(x, sh)
    assert torch.equal(st.gather(), x) and st.gather().dtype == x.dtype
    # pieces of entries that repeat a device are tensors of their own
    assert len({p.data_ptr() for p in st.pieces}) == n


def test_shard_raises_on_indivisible_dim_and_unknown_axis():
    mesh = make_mesh((4,), ("data",), ["cpu"] * 4)
    with pytest.raises(ValueError):
        TM.NamedSharding(mesh, ("data",)).shard(torch.zeros(6))
    with pytest.raises(ValueError):
        TM.NamedSharding(mesh, ("model",))
    with pytest.raises(ValueError):
        TM.NamedSharding(mesh, ("data", "data"))


def test_place_and_gather_tree():
    from repro_torch.optim.adamw import AdamWState
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    tree = {"w": torch.arange(32.0).reshape(8, 4),
            "opt": AdamWState(step=3, m=torch.ones(4, 2), v=torch.zeros(4))}
    shs = {"w": TM.NamedSharding(mesh, ("data", "model")),
           "opt": AdamWState(step=TM.replicated(mesh),
                             m=TM.NamedSharding(mesh, (None, "model")),
                             v=TM.replicated(mesh))}
    placed = TM.place_tree(tree, shs)
    assert isinstance(placed["w"], TM.ShardedTensor)
    assert placed["opt"].step == 3
    back = TM.gather_tree(placed, "cpu")
    assert torch.equal(back["w"], tree["w"])
    assert torch.equal(back["opt"].m, tree["opt"].m)
    assert back["opt"].step == 3


def test_make_mesh_takes_visible_cards_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [str(d) for d in make_mesh((2,), ("data",)).device_list] == \
        ["cuda:0", "cuda:1"]
    with pytest.raises(ValueError, match="needs 4 cards; 2 visible"):
        make_mesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data", "model"), ["cpu"] * 3)
    pm = make_production_mesh(multi_pod=True)
    assert pm.shape == {"pod": 2, "data": 16, "model": 16}
    assert TM.mesh_device_count(pm) == 512 and pm.device_list[0].type == "meta"


# ---------------------------------------------------------------------------
# shard_activation and the context
# ---------------------------------------------------------------------------


def test_shard_activation_returns_x_itself():
    x = torch.randn(4, 6)
    assert TM.shard_activation(x, ("batch", "act_embed")) is x
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    with TM.sharding_ctx(mesh, TM.lm_rules(False)):
        assert TM._CTX.mesh is mesh
        assert TM.shard_activation(x, ("batch", "act_embed")) is x
        assert TM.shard_activation(x, ("batch",)) is x  # rank mismatch
        with TM.sharding_ctx(mesh, dict(TM.lm_rules(False), batch="pod")):
            with pytest.raises(KeyError):  # the mesh has no "pod" axis
                TM.shard_activation(x, ("batch", "act_embed"))
        assert TM._CTX.rules == TM.lm_rules(False)
    assert TM._CTX.mesh is None and TM._CTX.rules is None


# ---------------------------------------------------------------------------
# build_step(mesh=...)
# ---------------------------------------------------------------------------


SMOKE_CELLS = [(a, s.name) for a in JC.list_archs()
               for s in JC.smoke_variant(JC.get_arch(a)).shapes
               if not s.skip_reason]


@pytest.mark.parametrize("mesh", ["2x2"])
@pytest.mark.parametrize("arch,shape", SMOKE_CELLS)
def test_build_step_layout_equals_reference(arch, shape, mesh):
    jspec_ = JC.smoke_variant(JC.get_arch(arch))
    tspec = TC.smoke_variant(TC.get_arch(arch))
    jb = JS.build_step(jspec_, jspec_.shape(shape), jmesh(mesh))
    tb = TS.build_step(tspec, tspec.shape(shape), device="cpu",
                       mesh=tmesh(mesh))
    assert tb.meta["rules"] == jb.rules
    assert tb.name == jb.name and tb.model_flops == jb.model_flops
    assert len(tb.meta["in_shardings"]) == len(jb.in_shardings)
    assert_same_layout(tb.meta["in_shardings"], jb.in_shardings,
                       tb.meta["abstract_args"], jb.abstract_args)
    for a in _flat_port(tb.meta["abstract_args"]).values():
        assert not isinstance(a, torch.Tensor) or a.device.type == "meta"
    if "microbatches" in jb.meta:
        assert tb.meta["mesh_plan"]["microbatches"] == \
            jb.meta["microbatches"]
    if jspec_.family == "gnn":
        assert tb.meta["n_edges"] == jb.meta["n_edges"]


@pytest.mark.parametrize("arch,shape,multi_pod", [
    ("qwen2-1.5b", "train_4k", False), ("deepseek-67b", "train_4k", True),
    ("qwen3-moe-30b-a3b", "decode_32k", False),
    ("minitron-8b", "prefill_32k", True), ("gatedgcn", "ogb_products", False),
    ("dlrm-mlperf", "retrieval_cand", True)])
def test_build_step_layout_on_production_meshes(arch, shape, multi_pod):
    """Full configs on the production meshes: the plan, the rules
    (``fsdp_seq``'s sequence rule, decode's KV rules) and every leaf."""
    mesh = "2x16x16" if multi_pod else "16x16"
    jspec_, tspec = JC.get_arch(arch), TC.get_arch(arch)
    jb = JS.build_step(jspec_, jspec_.shape(shape), jmesh(mesh),
                       multi_pod=multi_pod)
    tb = TS.build_step(tspec, tspec.shape(shape), device="meta",
                       mesh=tmesh(mesh, "meta"))
    assert tb.meta["rules"] == jb.rules
    assert tb.meta.get("mesh_plan", {}).get("microbatches", 1) == \
        jb.meta.get("microbatches", 1)
    assert_same_layout(tb.meta["in_shardings"], jb.in_shardings,
                       tb.meta["abstract_args"], jb.abstract_args)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_build_step_mesh_keeps_the_one_device_step(mesh):
    """A mesh adds the layout and the mesh's plan (``mesh_plan``, the
    reference's); the step keeps its one-device plan, and with no mesh
    there is no layout."""
    spec = TC.get_arch("qwen2-1.5b")
    shape = spec.shape("train_4k")
    plain = TS.build_step(spec, shape, device="meta")
    assert "in_shardings" not in plain.meta and "rules" not in plain.meta
    assert "mesh_plan" not in plain.meta
    b = TS.build_step(spec, shape, device="meta", mesh=tmesh(mesh, "meta"))
    keys = ("microbatches", "mode", "chunk")
    assert [b.meta[k] for k in keys] == [plain.meta[k] for k in keys]
    assert plain.meta["microbatches"] == shape.global_batch
    jspec_ = JC.get_arch("qwen2-1.5b")
    jb = JS.build_step(jspec_, jspec_.shape("train_4k"), jmesh(mesh),
                       multi_pod=mesh == "2x16x16")
    assert b.meta["mesh_plan"]["microbatches"] == jb.meta["microbatches"]
    assert b.meta["mesh_plan"]["microbatches"] != plain.meta["microbatches"]
