"""Fault-tolerant checkpointing of trees of tensors (one host).

The reference's on-disk layout and guarantees:
  * **Atomicity**: a save writes ``<dir>/step_%010d.tmp`` and renames it to
    ``<dir>/step_%010d`` only after every leaf and ``manifest.json`` are
    written and the manifest fsync'd; a crashed save never shadows a good
    checkpoint, and ``.tmp`` directories are never listed.
  * **Async**: ``save_async`` copies the leaves to host memory at once and
    writes them in a background thread while the loop steps on.
  * **Retention**: the ``keep`` most recent steps, plus every
    ``milestone_every``-th step for good.

A tree is nested dicts and NamedTuples (``AdamWState``) of tensors and
Python ints. Leaves are named by their path as the reference names them
(``params/layers/attn/wq``, ``opt/.m/embed``), one ``.npy`` a leaf.
numpy has no bfloat16, so a bf16 leaf is stored as its bits (int16) with
``"dtype": "bfloat16"`` in the manifest and restored bit for bit; a
Python int (``AdamWState.step``) is stored as an int32 leaf, as the
reference stores its step, and restored as an int.

A ``ShardedTensor`` leaf (``distributed.mesh_utils``) is saved as its
logical tensor, gathered from one replica of each piece, so the files are
those of the unsharded tree; ``restore(shardings=...)`` reads each leaf
once and cuts it into its sharding's pieces, whatever mesh the checkpoint
was taken on (``distributed.elastic``).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.mesh_utils import (NamedSharding, ShardedTensor,
                                                is_namedtuple)


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    join = (lambda k: f"{prefix}/{k}") if prefix else (lambda k: str(k))
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k], join(k))]
    if is_namedtuple(tree):
        return [x for f in tree._fields
                for x in _flatten(getattr(tree, f), join(f".{f}"))]
    return [(prefix, tree)]


def _unflatten_like(tree, values: Dict[str, Any], prefix: str = ""):
    join = (lambda k: f"{prefix}/{k}") if prefix else (lambda k: str(k))
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, values, join(k))
                for k, v in tree.items()}
    if is_namedtuple(tree):
        return type(tree)(*(_unflatten_like(getattr(tree, f), values,
                                            join(f".{f}"))
                            for f in tree._fields))
    return values[prefix]


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(array to store, manifest dtype)."""
    if isinstance(leaf, ShardedTensor):
        leaf = leaf.gather("cpu")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)  # later steps cannot touch it
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    if isinstance(leaf, (int, np.integer)) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32), "int32"
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, like, device, sharding=None):
    if not isinstance(like, (torch.Tensor, ShardedTensor)):
        return int(arr) if isinstance(like, int) else arr
    t = torch.from_numpy(np.require(arr, requirements="C"))  # keeps 0-d
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    if isinstance(sharding, NamedSharding):
        return ShardedTensor.place(t, sharding)
    if device is not None:
        return t.to(torch.device(device))
    if isinstance(like, ShardedTensor):
        return t.to(like.pieces[0].device)
    return t.to(like.device)


@dataclasses.dataclass
class Checkpointer:
    directory: str
    keep: int = 3
    milestone_every: int = 0  # additionally keep every k-th step forever

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: List[concurrent.futures.Future] = []
        self._lock = threading.Lock()

    # -- paths ------------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                manifest = os.path.join(self.directory, d, "manifest.json")
                if os.path.exists(manifest):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save -------------------------------------------------------------------

    def _snapshot(self, tree) -> List[Tuple[str, np.ndarray, str]]:
        """Device -> host copy (sync)."""
        return [(name, *_to_host(leaf)) for name, leaf in _flatten(tree)]

    def _write(self, step: int, snap: List[Tuple[str, np.ndarray, str]],
               meta: Dict[str, Any]):
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "meta": meta,
                    "n_hosts": 1, "leaves": {}}
        for name, arr, dtype in snap:
            fn = name.replace("/", "__") + ".host0.npy"  # one host
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"][name] = {
                "file": fn, "shape": list(arr.shape), "dtype": dtype}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def save(self, step: int, tree, meta: Optional[Dict[str, Any]] = None):
        self._write(step, self._snapshot(tree), meta or {})

    def save_async(self, step: int, tree,
                   meta: Optional[Dict[str, Any]] = None):
        snap = self._snapshot(tree)  # sync snapshot, async write
        fut = self._pool.submit(self._write, step, snap, meta or {})
        with self._lock:
            self._pending = [f for f in self._pending if not f.done()]
            self._pending.append(fut)
        return fut

    def wait(self):
        with self._lock:
            pending = list(self._pending)
        for f in pending:
            f.result()

    def _gc(self):
        steps = self.all_steps()
        protected = set(steps[-self.keep:]) if self.keep > 0 else set(steps)
        if self.milestone_every:
            protected |= {s for s in steps if s % self.milestone_every == 0}
        for s in steps:
            if s not in protected:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ------------------------------------------------------------------

    def restore(self, like_tree, step: Optional[int] = None, device=None,
                shardings=None) -> Tuple[Any, Dict[str, Any]]:
        """Restore into the structure of ``like_tree``: each tensor leaf on
        ``device`` (None: the device of ``like_tree``'s leaf), each int
        leaf as an int. ``shardings`` (a tree of the same structure, or
        None) places each tensor leaf as a ``ShardedTensor`` of its
        ``NamedSharding``. Returns (tree, manifest)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        likes = dict(_flatten(like_tree))
        placed = None if shardings is None else dict(_flatten(shardings))
        values = {}
        for name, info in manifest["leaves"].items():
            if name in likes:
                values[name] = _from_host(
                    np.load(os.path.join(d, info["file"])), info["dtype"],
                    likes[name], device,
                    None if placed is None else placed[name])
        return _unflatten_like(like_tree, values), manifest


class CheckpointManager:
    """Train-loop facade: interval policy + preemption hook."""

    def __init__(self, directory: str, save_interval: int = 100,
                 keep: int = 3, milestone_every: int = 0):
        self.ckpt = Checkpointer(directory, keep=keep,
                                 milestone_every=milestone_every)
        self.save_interval = save_interval
        self._preempted = threading.Event()

    def should_save(self, step: int) -> bool:
        return step > 0 and (step % self.save_interval == 0
                             or self._preempted.is_set())

    def signal_preemption(self):
        """Called by the cluster agent on an eviction notice."""
        self._preempted.set()

    def save(self, step: int, tree, meta=None, blocking: bool = False):
        if blocking or self._preempted.is_set():
            self.ckpt.save(step, tree, meta)
        else:
            self.ckpt.save_async(step, tree, meta)

    def restore_or_none(self, like_tree, device=None, shardings=None):
        if self.ckpt.latest_step() is None:
            return None, None
        return self.ckpt.restore(like_tree, device=device,
                                 shardings=shardings)
