"""Logical-axis sharding rules (MaxText-style) and the port's mesh types.

Parameters and activations are annotated with *logical* axis names
(schema-driven, see ``models.layers.param_specs``). A rules table maps
logical names to mesh axes; the tables, ``logical_to_spec``,
``_drop_indivisible`` and ``make_shardings`` are the reference's, value for
value.

The port runs one process and one controller. A mesh is an n-d array of
``torch.device`` entries with named axes, and a device may repeat (a mesh
of ``["cuda:0"] * 4`` lays four shards out on one card, as the sharded
device bank does). There is no SPMD partitioner: a ``NamedSharding`` cuts a
tensor into one piece a mesh entry (``shard``), a ``ShardedTensor`` holds
the pieces and reassembles the logical tensor (``gather``), and the
collectives (``distributed.collectives``) are plain functions over
per-entry tensors. ``shard_activation`` is the reference's sharding
constraint, which changes no value, so it returns its input.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

MeshAxis = Union[None, str, Tuple[str, ...]]
Rules = Dict[str, MeshAxis]


# ---------------------------------------------------------------------------
# Mesh types
# ---------------------------------------------------------------------------


class Mesh:
    """An n-d array of ``torch.device`` entries with named axes. ``shape``
    maps each axis name to its size, in axis order (as ``jax.sharding.Mesh``
    does); ``device_list`` is the entries in row-major order."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {arr.shape} given "
                             f"{len(axis_names)} axis names {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis name in {axis_names}")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            self.devices[idx] = torch.device(arr[idx])
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, arr.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> List[torch.device]:
        return list(self.devices.flat)

    def __repr__(self) -> str:
        devices = sorted(set(map(str, self.devices.flat)))
        return f"Mesh({self.shape}, devices={devices})"


class PartitionSpec(tuple):
    """One entry a dim: ``None``, a mesh axis name or a tuple of names (the
    dim split over their product, the first major). Trailing ``None``s are
    dropped, so specs compare as ``jax.sharding.PartitionSpec``s do."""

    def __new__(cls, *parts):
        parts = [tuple(p) if isinstance(p, list) else p for p in parts]
        while parts and parts[-1] is None:
            parts.pop()
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _axes_of(part: MeshAxis) -> Tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


class NamedSharding:
    """A ``PartitionSpec`` over a ``Mesh``: dim d of a tensor is cut into
    the product of its axes' sizes; along an axis the spec does not name,
    every piece is replicated."""

    def __init__(self, mesh: Mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)
        used: List[str] = []
        for part in self.spec:
            for a in _axes_of(part):
                if a not in mesh.shape:
                    raise ValueError(f"{self.spec}: no axis {a!r} in mesh "
                                     f"axes {mesh.axis_names}")
                if a in used:
                    raise ValueError(f"{self.spec}: axis {a!r} used twice")
                used.append(a)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec})"

    def _parts(self, ndim: int) -> List[Tuple[str, ...]]:
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec} has more entries than a "
                             f"{ndim}-d tensor has dims")
        return [_axes_of(p) for p in self.spec] + [()] * (ndim - len(self.spec))

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of each piece (``jax.sharding.NamedSharding
        .shard_shape``); a dim its axes do not divide raises."""
        out = []
        for dim, axes in zip(shape, self._parts(len(shape))):
            n = math.prod(self.mesh.shape[a] for a in axes)
            if dim % n:
                raise ValueError(f"dim of size {dim} is not divisible by "
                                 f"the {n} shards of {axes} in {self.spec}")
            out.append(dim // n)
        return tuple(out)

    def slices(self, shape: Sequence[int]) -> List[Tuple[slice, ...]]:
        """The index of each mesh entry's piece, in row-major order of the
        entries (``jax.sharding.Sharding.devices_indices_map``'s values):
        a dim split over axes (a, b) is cut into size_a x size_b blocks, and
        the entry at coordinates (i, j) takes block i x size_b + j."""
        piece = self.shard_shape(shape)
        parts = self._parts(len(shape))
        out = []
        for idx in np.ndindex(self.mesh.devices.shape):
            coord = dict(zip(self.mesh.axis_names, idx))
            sl = []
            for n, axes in zip(piece, parts):
                b = 0
                for a in axes:  # first axis major
                    b = b * self.mesh.shape[a] + coord[a]
                sl.append(slice(b * n, (b + 1) * n))
            out.append(tuple(sl))
        return out

    def shard(self, x: torch.Tensor) -> List[torch.Tensor]:
        """One piece a mesh entry, row-major: the slice the entry's
        coordinates select, copied onto the entry's device (an entry that
        repeats a device still gets a tensor of its own)."""
        return [x[sl].to(device=dev, copy=True)
                for dev, sl in zip(self.mesh.device_list,
                                   self.slices(x.shape))]


class ShardedTensor:
    """A logical tensor held as one piece a mesh entry of ``sharding``."""

    def __init__(self, sharding: NamedSharding, pieces: List[torch.Tensor],
                 shape: Sequence[int], dtype: torch.dtype):
        if len(pieces) != sharding.mesh.size:
            raise ValueError(f"{len(pieces)} pieces for a mesh of "
                             f"{sharding.mesh.size} entries")
        self.sharding, self.pieces = sharding, list(pieces)
        self.shape, self.dtype = torch.Size(shape), dtype

    @classmethod
    def place(cls, x: torch.Tensor, sharding: NamedSharding) -> "ShardedTensor":
        return cls(sharding, sharding.shard(x), x.shape, x.dtype)

    def __repr__(self) -> str:
        return (f"ShardedTensor({tuple(self.shape)}, {self.dtype}, "
                f"{self.sharding})")

    def gather(self, device=None) -> torch.Tensor:
        """The logical tensor on ``device`` (None: the first piece's), built
        from one replica of each piece: bit-equal to the placed tensor."""
        dev = self.pieces[0].device if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        seen = set()
        for piece, sl in zip(self.pieces, self.sharding.slices(self.shape)):
            key = tuple((s.start, s.stop) for s in sl)
            if key not in seen:
                seen.add(key)
                out[sl].copy_(piece)
        return out


def is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts and NamedTuples; anything
    else, an axes tuple too, is a leaf) and the matching leaves of
    ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    return fn(tree, *rest)


def place_tree(tree, shardings):
    """Each tensor leaf as a ``ShardedTensor`` under its sharding; other
    leaves (a step count) stay as they are."""
    return tree_map(lambda x, s: ShardedTensor.place(x, s)
                    if isinstance(x, torch.Tensor) else x, tree, shardings)


def gather_tree(tree, device=None):
    """Each ``ShardedTensor`` leaf gathered onto ``device``."""
    return tree_map(lambda x: x.gather(device)
                    if isinstance(x, ShardedTensor) else x, tree)


# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------

# Shared logical axes:
#   params : embed, mlp, heads, kv_heads, head_dim, vocab, layer, expert,
#            table_rows, hidden
#   acts   : batch, seq, act_embed, kv_seq, nodes, edges, cands
#
# "fsdp" = shard weights over the data axis (ZeRO-3 style); "tp" = tensor
# parallel over the model axis.

def lm_rules(multi_pod: bool, *, seq_shard_kv: bool = False,
             fsdp: bool = True) -> Rules:
    dp: MeshAxis = ("pod", "data") if multi_pod else "data"
    return {
        # params
        "embed": "data" if fsdp else None,
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "vocab": "model",
        "layer": None,
        "expert": "model",
        # activations
        "batch": dp,
        "attn_batch": dp,   # attention-entry batch dim (override for archs
                            # whose heads don't divide the model axis)
        "seq": None,
        "act_embed": None,
        "kv_seq": "data" if seq_shard_kv else None,
        "kv_batch": None if seq_shard_kv else dp,
        "cands": None,
    }


def gnn_rules(multi_pod: bool) -> Rules:
    dp: MeshAxis = ("pod", "data") if multi_pod else "data"
    return {
        "embed": None, "mlp": "model", "hidden": None, "layer": None,
        "vocab": None, "heads": None, "kv_heads": None, "head_dim": None,
        "batch": dp, "seq": None, "act_embed": None,
        "nodes": dp, "edges": (dp, "model") if isinstance(dp, str)
        else ("pod", "data", "model"),
        "cands": None,
    }


def recsys_rules(multi_pod: bool) -> Rules:
    dp: MeshAxis = ("pod", "data") if multi_pod else "data"
    return {
        "embed": None, "mlp": "model", "hidden": None, "layer": None,
        "heads": None, "kv_heads": None, "head_dim": None,
        "table_rows": ("data", "model"),
        "vocab": ("data", "model"),
        "batch": dp, "seq": None, "act_embed": None,
        "cands": ("data", "model"),
    }


def mem_rules(multi_pod: bool) -> Rules:
    r = lm_rules(multi_pod)
    r["vocab"] = "model"
    return r


def rules_for_family(family: str, multi_pod: bool, **kw) -> Rules:
    if family == "lm":
        return lm_rules(multi_pod, **kw)
    if family == "gnn":
        return gnn_rules(multi_pod)
    if family == "recsys":
        return recsys_rules(multi_pod)
    if family == "mem":
        return mem_rules(multi_pod)
    raise ValueError(family)


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------


class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.rules: Optional[Rules] = None


_CTX = _Ctx()


@contextlib.contextmanager
def sharding_ctx(mesh: Optional[Mesh], rules: Optional[Rules]):
    """Make ``mesh`` and ``rules`` the thread's current ones inside the
    block (read by ``shard_activation``)."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def logical_to_spec(axes: Sequence[Optional[str]],
                    rules: Rules) -> PartitionSpec:
    """Map logical axis names to a PartitionSpec, dropping mesh axes an
    earlier dim already uses."""
    used = set()
    parts = []
    for name in axes:
        mesh_ax = rules.get(name) if name is not None else None
        if mesh_ax is None:
            parts.append(None)
            continue
        keep = tuple(a for a in _axes_of(mesh_ax) if a not in used)
        used.update(keep)
        if not keep:
            parts.append(None)
        elif len(keep) == 1:
            parts.append(keep[0])
        else:
            parts.append(keep)
    return PartitionSpec(*parts)


def _drop_indivisible(spec: PartitionSpec, shape: Tuple[int, ...],
                      mesh: Mesh) -> PartitionSpec:
    """Remove mesh axes whose size does not divide the array dim, left to
    right (2 KV heads on a 16-way model axis -> replicate the KV heads)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, names in zip(shape, parts):
        if names is None:
            out.append(None)
            continue
        keep = []
        size = dim
        for n in _axes_of(names):
            if size % mesh.shape[n] == 0:
                keep.append(n)
                size //= mesh.shape[n]
        out.append(None if not keep else
                   (keep[0] if len(keep) == 1 else tuple(keep)))
    return PartitionSpec(*out)


def shard_activation(x: torch.Tensor,
                     axes: Sequence[Optional[str]]) -> torch.Tensor:
    """The reference's activation sharding constraint, which changes no
    value: returns ``x`` itself. Inside ``sharding_ctx`` it still works out
    the spec, so a rule naming an axis the mesh lacks raises as there."""
    if _CTX.mesh is None or _CTX.rules is None or x.ndim != len(axes):
        return x
    _drop_indivisible(logical_to_spec(axes, _CTX.rules), tuple(x.shape),
                      _CTX.mesh)
    return x


def make_shardings(spec_tree, mesh: Mesh, rules: Rules, abstract_tree=None):
    """Logical-axes tree -> NamedSharding tree. With ``abstract_tree`` (the
    matching tensors, on ``meta`` or not), axes that don't divide a dim are
    dropped leaf by leaf."""
    if abstract_tree is None:
        return tree_map(
            lambda axes: NamedSharding(mesh, logical_to_spec(axes, rules)),
            spec_tree)
    return tree_map(
        lambda axes, ab: NamedSharding(mesh, _drop_indivisible(
            logical_to_spec(axes, rules), tuple(ab.shape), mesh)),
        spec_tree, abstract_tree)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def mesh_device_count(mesh: Mesh) -> int:
    return math.prod(mesh.shape.values())
