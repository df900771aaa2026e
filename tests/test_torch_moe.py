"""Port parity: the MoE layer (router, capacity semantics, grouped expert
GEMM, combine, shared expert, aux loss) against the reference's
``moe_apply`` and its dense oracle, fp32, forward and gradient."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import layers as JL
from repro.models import moe as JM
from repro_torch.configs.base import MoEConfig
from repro_torch.kernels.moe_gemm import ops as MO
from repro_torch.models import moe as TM
from repro_torch.models.convert import params_from_jax

TOL = 1e-5


def _setup(E=4, K=2, cf=8.0, d=16, F=32, B=2, S=8, shared=0, seed=0):
    kw = dict(n_experts=E, top_k=K, d_ff_expert=F, capacity_factor=cf,
              n_shared_experts=shared)
    jmoe, moe = JMoEConfig(**kw), MoEConfig(**kw)
    jp = JL.init_params(jax.random.PRNGKey(seed), JM.moe_schema(d, jmoe))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)
    return jmoe, moe, jp, tp, x


@pytest.mark.parametrize("case", [
    dict(cf=16.0),                        # ample capacity: nothing dropped
    dict(cf=0.1, B=4, S=16),              # forced drops (C = 8 < S*K/E)
    dict(cf=16.0, shared=1),              # a shared expert
    dict(E=8, K=3, cf=1.0, B=3, S=24, d=24, F=40),  # some drops, K = 3
])
def test_moe_apply_matches_reference(case):
    jmoe, moe, jp, tp, x = _setup(**case)
    y_j, aux_j = JM.moe_apply(jp, x, jmoe)
    before = MO.launches
    y_t, aux_t = TM.moe_apply(tp, torch.from_numpy(x), moe)
    assert MO.launches == before
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6,
                               atol=1e-9)
    assert TM.capacity(x.shape[1], moe) == JM.capacity(x.shape[1], jmoe)


@pytest.mark.parametrize("shared", [0, 1])
def test_dense_oracle_matches_reference(shared):
    jmoe, moe, jp, tp, x = _setup(shared=shared, cf=16.0)
    y_j, _ = JM.moe_apply_dense(jp, x, jmoe)
    y_t, aux_t = TM.moe_apply_dense(tp, torch.from_numpy(x), moe)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=TOL)
    assert float(aux_t) == 0.0
    # ample capacity: the port's capacity path equals the dense oracle too
    y_c, _ = TM.moe_apply(tp, torch.from_numpy(x), moe)
    np.testing.assert_allclose(y_c.numpy(), y_t.numpy(), atol=2e-5)


def test_forced_drops_zero_the_dropped_assignments():
    """With C = 8 and every token routed to the same two experts (positive
    inputs, a router that scores experts 1 and 2 highest), each group keeps
    its first 8 assignments per expert and the rest add 0."""
    jmoe, moe, jp, tp, x = _setup(E=4, K=2, cf=0.1, B=2, S=16)
    x = np.abs(x) + 0.1
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    tp["router"][:, 1] = 10.0
    tp["router"][:, 2] = 5.0
    jp = dict(jp, router=tp["router"].numpy())
    y_j, _ = JM.moe_apply(jp, x, jmoe)
    y_t, _ = TM.moe_apply(tp, torch.from_numpy(x), moe)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=TOL)
    assert not y_t[:, 8:].any()  # tokens 8..15 of each group: both dropped
    assert y_t[:, :8].abs().amax() > 0


def test_schema_matches_reference():
    jmoe, moe, jp, tp, _ = _setup(shared=1)
    ours = TM.moe_schema(16, moe)
    assert sorted(ours) == sorted(jp)
    for name, leaf in jp.items():
        if isinstance(leaf, dict):
            for k2, v2 in leaf.items():
                assert ours[name][k2].shape == v2.shape
        else:
            assert ours[name].shape == leaf.shape


def _forced(jmoe, moe, jp, tp, x):
    """Every token routed to experts 1 and 2 (positive inputs, a router
    that scores them highest), so each group of 16 keeps 8 of each."""
    x = np.abs(x) + 0.1
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    tp["router"][:, 1] = 10.0
    tp["router"][:, 2] = 5.0
    return dict(jp, router=tp["router"].numpy()), tp, x


def _drops(tp, x, moe):
    """The assignments the capacity drops (position in expert >= C)."""
    _, _, top_i = TM._route(tp, x, moe)
    B, S, _ = x.shape
    onehot = torch.nn.functional.one_hot(top_i.reshape(B, -1),
                                         moe.n_experts)
    pos = ((torch.cumsum(onehot, 1) - 1) * onehot).sum(-1)
    return int((pos >= TM.capacity(S, moe)).sum())


@pytest.mark.parametrize("case,drops", [
    (dict(cf=16.0), False),
    (dict(cf=0.1, B=4, S=16), True),
    (dict(cf=16.0, shared=1), False),
    (dict(E=8, K=3, cf=1.0, B=3, S=24, d=24, F=40), False),
    (dict(E=4, K=2, cf=0.1, B=2, S=16, forced=True), True)])
def test_moe_apply_grads_match_reference(case, drops):
    """The gradients of x, the router, the three expert weights (and the
    shared expert's) of sum(y * g) + aux through the grouped GEMM's autograd
    Function on the CPU against jax.grad of the reference's moe_apply,
    within 1e-5 of each leaf's scale; the dropped assignments (position in
    expert >= C, zeroed at the combine) add nothing, as in the reference,
    where they never enter the buffer."""
    case = dict(case)
    forced = case.pop("forced", False)
    jmoe, moe, jp, tp, x = _setup(**case)
    if forced:
        jp, tp, x = _forced(jmoe, moe, jp, tp, x)
    tx = torch.from_numpy(x)
    assert (_drops(tp, tx, moe) > 0) == drops
    g = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def j_loss(p, xx):
        y, aux = JM.moe_apply(p, xx, jmoe)
        return jnp.sum(y * g) + aux

    jgp, jgx = jax.grad(j_loss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()
              if k != "shared"}
    if "shared" in tp:
        leaves["shared"] = {k: v.clone().requires_grad_()
                            for k, v in tp["shared"].items()}
    xl = tx.clone().requires_grad_()
    y, aux = TM.moe_apply(leaves, xl, moe)
    flat = [(k, v) for k, v in leaves.items() if k != "shared"] + \
        [(f"shared/{k}", v) for k, v in leaves.get("shared", {}).items()]
    before = (MO.launches, MO.bwd_launches)
    grads = torch.autograd.grad((y * torch.from_numpy(g)).sum() + aux,
                                [v for _, v in flat] + [xl])
    assert (MO.launches, MO.bwd_launches) == before
    want = [np.asarray(jgp["shared"][k.split("/")[1]] if "/" in k
                       else jgp[k]) for k, _ in flat] + [np.asarray(jgx)]
    for name, got, w in zip([k for k, _ in flat] + ["x"], grads, want):
        err = np.abs(got.numpy() - w).max()
        assert err <= TOL * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("needs_grad", ["x", "weights", "both", "none"])
def test_expert_ffn_takes_three_grouped_gemms_under_grad_mode(monkeypatch,
                                                              needs_grad):
    """``expert_ffn`` on bf16 rows at a token block the fused gate/up
    kernel's shapes take (64, d and F multiples of 8): where a gradient is
    recorded it runs gate, up and down as three grouped GEMMs and never the
    fused call (which has no backward), and its output and gradients are
    bit for bit those of the three steps written out; on the CPU, with no
    gradient, it takes the same three steps (the fused launch is the card's
    alone)."""
    from repro_torch.kernels.moe_gemm import kernel as MK
    bf = torch.bfloat16
    E, K, T, d, F = 4, 2, 128, 16, 40
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32)
                         ).to(bf)
    ids = torch.from_numpy(rng.integers(0, E, T * K).astype(np.int64))
    p = {k: torch.from_numpy((rng.standard_normal(shape) * 0.3).astype(
        np.float32)).to(bf) for k, shape in (("w_gate", (E, d, F)),
                                             ("w_up", (E, d, F)),
                                             ("w_down", (E, F, d)))}
    bt = MO.block_t_for(T * K, E)
    assert bt == 64 and MK.kernel_for(bf, bt, d, F) == "wgmma"
    calls = {"sorted": 0, "swiglu": 0}

    def spy(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(MO, "moe_gemm_sorted",
                        spy("sorted", MO.moe_gemm_sorted))
    monkeypatch.setattr(MO, "moe_gemm_sorted_swiglu",
                        spy("swiglu", MO.moe_gemm_sorted_swiglu))
    g_out = torch.from_numpy(rng.standard_normal((T * K, d)).astype(
        np.float32)).to(bf)

    def leaves():
        xl = x.clone().requires_grad_(needs_grad in ("x", "both"))
        pl = {k: v.clone().requires_grad_(needs_grad in ("weights", "both"))
              for k, v in p.items()}
        return xl, pl

    def written_out(xl, pl):
        plan = MO.plan(ids, E, bt)
        xs = MO.scatter_rows(xl, plan, K)

        def grouped(h, w):
            return MO.moe_gemm_sorted(h, plan.block_expert, w, bt,
                                      plan.used, plan.ends)
        g, u = grouped(xs, pl["w_gate"]), grouped(xs, pl["w_up"])
        h = torch.nn.functional.silu(g.float()).to(bf) * u
        return MO.gather_rows(grouped(h, pl["w_down"]), plan)

    def run(fn):
        xl, pl = leaves()
        calls.update(sorted=0, swiglu=0)
        y = fn(xl, pl)
        assert calls == {"sorted": 3, "swiglu": 0}
        wrt = [t for t in (xl, *pl.values()) if t.requires_grad]
        return y, (torch.autograd.grad((y.float() * g_out.float()).sum(),
                                       wrt) if wrt else ())

    y, grads = run(lambda xl, pl: TM.expert_ffn(pl, xl, ids, K))
    y_w, grads_w = run(written_out)
    assert torch.equal(y, y_w)
    assert len(grads) == len(grads_w) == {"x": 1, "weights": 3, "both": 4,
                                          "none": 0}[needs_grad]
    for a, b in zip(grads, grads_w):
        assert torch.equal(a, b)


def _dropless_setup(seed=0, E=8, K=3, d=16, F=24, B=2, S=20):
    from repro_torch.configs.base import RouterConfig
    from repro_torch.models.layers import init_params
    moe = MoEConfig(n_experts=E, top_k=K, d_ff_expert=F, n_shared_experts=1)
    router = RouterConfig(routed_scaling_factor=2.446)
    gen = torch.Generator().manual_seed(seed)
    p = init_params(gen, TM.moe_schema(d, moe, router=router),
                    dtype=torch.bfloat16, device="cpu")
    x = torch.randn((B, S, d), generator=gen).to(torch.bfloat16)
    return moe, router, p, x


def _spy_rows(monkeypatch):
    calls = dict.fromkeys(("dispatch_rows", "combine_rows", "scatter_rows",
                           "gather_rows"), 0)
    for name in calls:
        fn = getattr(MO, name)

        def run(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(MO, name, run)
    return calls


def _dropless_written_out(p, x, moe, router):
    """The dropless layer's torch steps written out: route, scatter, the
    three grouped GEMMs' steps, gather, the batched product, the shared
    experts."""
    from repro_torch.models import layers as L
    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    top_i, w = TM.route_sigmoid(p, x2, moe, router)
    ids = top_i.reshape(-1)
    bt = MO.block_t_for(ids.shape[0], moe.n_experts)
    plan = MO.plan(ids, moe.n_experts, bt)
    xs = MO.scatter_rows(x2, plan, moe.top_k)

    def grouped(h, wt):
        return MO.moe_gemm_sorted(h, plan.block_expert, wt.to(x.dtype), bt,
                                  plan.used, plan.ends)
    g, u = grouped(xs, p["w_gate"]), grouped(xs, p["w_up"])
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    y_tok = MO.gather_rows(grouped(h, p["w_down"]), plan)
    y = torch.bmm(w.to(x.dtype)[:, None, :],
                  y_tok.view(B * S, moe.top_k, d))[:, 0]
    return (y + L.swiglu(p["shared"], x2)).view(B, S, d)


@pytest.mark.parametrize("needs_grad", ["none", "x", "weights"])
def test_dropless_layer_takes_the_torch_steps_under_grad_mode_and_on_the_cpu(
        monkeypatch, needs_grad):
    """``moe_apply_dropless`` on the CPU, with or without a gradient
    recorded through x or the expert weights: the rows move by
    ``scatter_rows``, ``gather_rows`` and the batched product (the row
    kernels are the card's alone, and have no backward), once each a call,
    and the output and gradients are bit for bit those of the steps written
    out."""
    moe, router, p, x = _dropless_setup()

    def leaves():
        xl = x.clone().requires_grad_(needs_grad == "x")
        pl = {k: (v.clone().requires_grad_(needs_grad == "weights")
                  if k in ("w_gate", "w_up", "w_down") else v)
              for k, v in p.items()}
        return xl, pl

    g_out = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
    calls = _spy_rows(monkeypatch)

    def run(fn):
        xl, pl = leaves()
        calls.update(dict.fromkeys(calls, 0))
        y = fn(xl, pl)
        assert calls == {"dispatch_rows": 0, "combine_rows": 0,
                         "scatter_rows": 1, "gather_rows": 1}
        wrt = [t for t in (xl, pl["w_gate"], pl["w_up"], pl["w_down"])
               if t.requires_grad]
        return y, (torch.autograd.grad((y.float() * g_out).sum(), wrt)
                   if wrt else ())

    y, grads = run(lambda xl, pl: TM.moe_apply_dropless(pl, xl, moe,
                                                        router)[0])
    y_w, grads_w = run(lambda xl, pl: _dropless_written_out(pl, xl, moe,
                                                            router))
    assert torch.equal(y, y_w)
    assert len(grads) == len(grads_w) == {"none": 0, "x": 1,
                                          "weights": 3}[needs_grad]
    for a, b in zip(grads, grads_w):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K", [1, 3, 6])
def test_moe_apply_dropless_on_the_row_path_gives_the_same_bits(
        monkeypatch, K):
    """With ``rows_take`` made true on the CPU, the dropless layer moves
    its rows through ``dispatch_rows`` and ``combine_rows`` (their plain
    versions here), once each a call and never through ``scatter_rows`` or
    ``gather_rows``, and its output is bit for bit the torch steps'."""
    moe, router, p, x = _dropless_setup(seed=K, K=K)
    want = TM.moe_apply_dropless(p, x, moe, router)[0]
    calls = _spy_rows(monkeypatch)
    monkeypatch.setattr(MO, "rows_take", lambda *t: True)
    with torch.no_grad():
        got = TM.moe_apply_dropless(p, x, moe, router)[0]
    assert calls == {"dispatch_rows": 1, "combine_rows": 1,
                     "scatter_rows": 0, "gather_rows": 0}
    assert torch.equal(got, want)
