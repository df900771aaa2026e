"""Helpers shared by the training-path parity tests
(``test_torch_train*.py``): running the reference's and the port's train
steps on the same batches and comparing what they leave behind.

The losses and steps run on the init's weights with the attention
projections rescaled to fan-in d (``fan_in_d``): the init takes the q/k
fan-in as H, so its attention logits reach tens and the softmax is near
one-hot, which leaves a gradient ill-conditioned in fp32. On the qwen2
smoke init both packages' gradients lie 2.5-3e-4 of each leaf's scale
from a float64 gradient (and 5e-4 from each other); at fan-in d both lie
within 2e-6 of it, so 1e-4 holds the port to the reference and still sees
a fault the size of one bf16 rounding."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.mesh_utils import sharding_ctx
from repro.launch import steps as JS
from repro_torch.optim.adamw import AdamW


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """Two intra-op threads for the module's torch ops: the smoke shapes
    gain no wall time from more, and more would take cores from the
    suite's other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def mesh11():
    """The (1, 1) data x model mesh, its axes Auto (jax 0.9 makes them
    Explicit by default, which the reference's sharding constraints do
    not take)."""
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def fp32(spec):
    return dataclasses.replace(spec, model=dataclasses.replace(
        spec.model, dtype="float32"))


def _scale_attn(a):
    a = dict(a)
    _, d, H, _ = a["wq"].shape
    for w in ("wq", "wk", "wv"):
        a[w] = a[w] * (H / d) ** 0.5
    a["wo"] = a["wo"] / H ** 0.5
    return a


def fan_in_d(params):
    """The same weights with the attention projections at fan-in d (an LM
    tree, or a MEM tree of towers)."""
    if "towers" in params:
        return dict(params, towers={
            m: dict(tp, layers=dict(tp["layers"],
                                    attn=_scale_attn(tp["layers"]["attn"])))
            for m, tp in params["towers"].items()})
    return dict(params, layers=dict(params["layers"],
                                    attn=_scale_attn(params["layers"]["attn"])))


def leaf_errs(got, want, prefix=""):
    """{path: max |got - want| / max |want|} over the leaves."""
    if isinstance(got, dict):
        out = {}
        for k in got:
            out.update(leaf_errs(got[k], want[k], f"{prefix}/{k}"))
        return out
    w = np.asarray(want, np.float64)
    g = got.detach().double().numpy()
    return {prefix: np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)}


def assert_leaves(got, want, tol, what):
    errs = leaf_errs(got, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, f"{what}: {worst} off by {errs[worst]:.2e}"


def ref_run(spec, shape, params, batches, **kw):
    """The reference's train_step, jitted, over ``batches``: per-step
    metrics and the last params and optimizer state."""
    mesh = mesh11()
    bundle = JS.build_step(spec, shape, mesh, **kw)
    opt = jax.tree.map(lambda ab: jnp.zeros(ab.shape, ab.dtype),
                       bundle.abstract_args[1])
    fn = jax.jit(bundle.fn)
    metrics = []
    with sharding_ctx(mesh, bundle.rules):
        for b in batches:
            params, opt, m = fn(params, opt, {k: jnp.asarray(v)
                                              for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, to_np(params), opt


def port_run(bundle, params, batches):
    opt = AdamW().init(params)
    metrics = []
    for b in batches:
        params, opt, m = bundle.fn(params, opt, {k: torch.as_tensor(v)
                                                 for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, params, opt


def _beyond(got, want, tol):
    """{path: share of the leaf's elements further than ``tol`` of the
    leaf's scale (its largest |element|)}."""
    if isinstance(got, dict):
        out = {}
        for k in got:
            out.update({f"/{k}{p}": v for p, v in
                        _beyond(got[k], want[k], tol).items()})
        return out
    w = np.asarray(want, np.float64)
    d = np.abs(got.detach().double().numpy() - w)
    return {"": float((d > tol * max(np.abs(w).max(), 1e-30)).mean())}


def check_steps(got, want, *, ties=0.0, tol=1e-4):
    """Per step loss, grad norm and lr within ``tol`` relative; the Adam
    moments after the last step within ``tol`` of each leaf's scale, all
    but a share ``ties`` of a leaf's elements; the params within ``tol``
    of each leaf's scale or 10 % of the first step's lr, whichever is
    larger (an element whose gradient is near Adam's eps, as in the
    zero-initialised k bias, moves by a share of lr that the two
    packages' fp32 noise sets: up to 6 % of lr measured)."""
    (tm, tp, to), (jm, jp, jo) = got, want
    for t, j in zip(tm, jm):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(t[key], j[key], rtol=tol, err_msg=key)
    assert to.step == int(jo.step) == len(tm)
    for what, g, w in (("first moment", to.m, to_np(jo.m)),
                       ("second moment", to.v, to_np(jo.v))):
        share = _beyond(g, w, tol)
        worst = max(share, key=share.get)
        assert share[worst] <= ties, f"{what}: {share[worst]:.3%} of " \
            f"{worst} beyond {tol} of its scale"
    floor = 0.1 * jm[0]["lr"]
    for path, err in leaf_errs(tp, jp).items():
        leaf = jp
        for k in path.strip("/").split("/"):
            leaf = leaf[k]
        scale = np.abs(leaf).max()
        assert err * scale <= max(tol * scale, floor), (path, err)
