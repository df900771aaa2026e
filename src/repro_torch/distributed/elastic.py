"""Elastic scaling: restore any checkpoint onto any mesh.

Checkpoints store logical (unsharded) tensors and a manifest; restoring
applies the *current* mesh's shardings (``Checkpointer.restore(shardings=
...)``), so a checkpoint taken on any mesh loads onto any other whose axes
divide the tensors. ``validate_divisibility`` checks that every leaf's
sharded dims divide evenly under the new mesh: the one real constraint
when a job grows or shrinks (512 -> 256 chips after losing a pod).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.distributed import mesh_utils
from repro_torch.distributed.mesh_utils import Mesh, NamedSharding


def _leaves_with_paths(tree, path: Tuple[str, ...] = ()):
    """(path, leaf) in the reference's order, each path entry as JAX
    prints its key: ``['name']`` for a dict key, ``.field`` for a
    NamedTuple field."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], path + (f"[{k!r}]",))
    elif mesh_utils.is_namedtuple(tree):
        for f in tree._fields:
            yield from _leaves_with_paths(getattr(tree, f), path + (f".{f}",))
    else:
        yield path, tree


def validate_divisibility(tree, shardings) -> List[str]:
    """Returns the list of leaf-path problems (empty == ok)."""
    problems = []
    for (path, leaf), (_, sh) in zip(_leaves_with_paths(tree),
                                     _leaves_with_paths(shardings)):
        if not isinstance(sh, NamedSharding):
            continue
        for dim, names in enumerate(sh.spec):
            if names is None:
                continue
            names = (names,) if isinstance(names, str) else names
            div = math.prod(sh.mesh.shape[n] for n in names)
            if leaf.shape[dim] % div != 0:
                problems.append(
                    f"{'/'.join(path)}: dim {dim} size "
                    f"{leaf.shape[dim]} not divisible by mesh factor {div}")
    return problems


def elastic_restore(ckpt: Checkpointer, like_tree, mesh: Mesh, rules,
                    spec_tree, step: Optional[int] = None):
    """Restore and reshard onto ``mesh``; ``spec_tree`` is the
    logical-axes tree. Returns (tree of ``ShardedTensor``s, manifest)."""
    shardings = mesh_utils.make_shardings(spec_tree, mesh, rules)
    return ckpt.restore(like_tree, step=step, shardings=shardings)


def survivors_mesh(devices: Sequence, shape: Tuple[int, ...],
                   axis_names: Tuple[str, ...], failed: int = 0) -> Mesh:
    """The largest mesh of the same axis names after ``failed`` device
    losses, halving the ``data``/``pod`` axes first (model and expert
    shards must stay whole), over the first devices of ``devices``."""
    n = len(devices) - failed
    shape = list(shape)
    data_axes = [i for i, a in enumerate(axis_names) if a in ("data", "pod")]
    for i in data_axes[::-1]:
        while shape[i] > 1 and math.prod(shape) > n:
            shape[i] //= 2
    total = math.prod(shape)
    if total > n:
        raise RuntimeError(f"cannot fit mesh {shape} on {n} devices")
    return Mesh(np.array(list(devices[:total]), dtype=object).reshape(shape),
                axis_names)
