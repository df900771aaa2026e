"""What a RECALL cell needs: the port's config objects built from
the configuration file, the weights and the photo/caption pool made from
the seed, the pre-exit predictor fit in plain torch, and the judge of a
drain (the exit each photo took, its stored coarse row and its cached
activations) against the plain reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from bench.lib import data as D
from bench.lib import weights as W
from bench.reference import imagebind as RI
from bench.reference import int4 as R4
from bench.reference import layers as RL
from bench.reference import predictor as RP

BLOCK = 32          # photos a block of the reference
TIE = 1e-4          # predictor logits closer than this are a tie


def mem_configs(cfg: Dict):
    """(MEMConfig, RecallConfig) of the port from the configuration file."""
    from repro_torch.configs.base import MEMConfig, RecallConfig, TowerConfig
    towers = tuple(TowerConfig(t["modality"], n_layers=t["n_layers"],
                               d_model=t["d_model"], n_heads=t["n_heads"],
                               d_ff=t["d_ff"], n_tokens=t["n_tokens"],
                               d_input=t["d_input"], vocab=t.get("vocab", 0))
                   for t in cfg["towers"])
    mem = MEMConfig(towers=towers, embed_dim=cfg["embed_dim"],
                    logit_scale_init=cfg["logit_scale_init"],
                    norm_eps=cfg["norm_eps"], dtype=cfg["dtype"])
    r = cfg["recall"]
    rc = RecallConfig(exit_interval=r["exit_interval"],
                      superficial_layers=r["superficial_layers"],
                      predictor_hidden=r["predictor_hidden"],
                      filter_top_k=r["filter_top_k"],
                      query_granularities=r["query_granularities"],
                      cache_bits=r["cache_bits"])
    return mem, rc


def tower_cfg(cfg: Dict, modality: str) -> Dict:
    for t in cfg["towers"]:
        if t["modality"] == modality:
            return t
    raise KeyError(modality)


def vision_exits(cfg: Dict) -> tuple:
    return RI.exit_layers(tower_cfg(cfg, "vision")["n_layers"],
                          cfg["recall"]["exit_interval"])


def make_params(cfg: Dict, modalities: Sequence[str], seed: int, device):
    """The towers the cell runs, in the port's layout (``mem_schema``)."""
    from repro_torch.models.imagebind import mem_schema
    mem, rc = mem_configs(cfg)
    schema = mem_schema(mem, rc)
    sub = {"towers": {m: schema["towers"][m] for m in modalities}}
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg["dtype"]]
    return W.make_params(sub, seed=seed, dtype=dtype, device=device)


def make_pool(cfg: Dict, n: int, seed: int, device,
              modalities: Sequence[str]) -> Dict[str, torch.Tensor]:
    towers = [t for t in cfg["towers"] if t["modality"] in modalities]
    return D.multimodal_pairs(seed, n, towers, device)


@torch.no_grad()
def superficial(cfg: Dict, tp: Dict, photos: torch.Tensor, prec: str,
                keep_h: bool = True):
    """(CLS after each superficial layer (N, B, d), state after layer N
    or None) of the reference, in blocks."""
    t = tower_cfg(cfg, "vision")
    N = cfg["recall"]["superficial_layers"]
    cls, hs = [], []
    for i in range(0, len(photos), BLOCK):
        out = RI.tower(tp, photos[i:i + BLOCK].float(), n_heads=t["n_heads"],
                       eps=cfg["norm_eps"], end=N, prec=prec,
                       keep_h=(N,) if keep_h else ())
        cls.append(out["cls"])
        hs.extend(out["h"].values())
    return torch.cat(cls, dim=1), torch.cat(hs) if hs else None


def features(cfg: Dict, tp: Dict, photos: torch.Tensor) -> torch.Tensor:
    """The reference's pooled state after the superficial layers, the
    predictor's input."""
    return superficial(cfg, tp, photos, "fp32", keep_h=False)[0][-1]


def fit_predictor(cfg: Dict, feats: torch.Tensor, difficulty: torch.Tensor,
                  seed: int):
    """The predictor handed to the program: fit on the reference's
    superficial features of the pool, to labels whose mean exit is the
    configuration's ``mean_exit_layers``. Returns (params, label mean
    depth, train accuracy)."""
    exits = vision_exits(cfg)
    labels = RP.exit_labels(difficulty.cpu().numpy(), exits,
                            cfg["mean_exit_layers"])
    lab = torch.as_tensor(labels, device=feats.device)
    p = RP.fit(feats, lab, hidden=cfg["recall"]["predictor_hidden"],
               n_exits=len(exits), seed=seed)
    with torch.no_grad():
        acc = float((RP.logits(p, feats).argmax(-1) == lab).float().mean())
    return p, float(np.mean(np.asarray(exits)[labels])), acc


@dataclass
class ServedDrain:
    """What a drain stored for some photos: the pool index of each photo,
    the exit layer it took, its stored coarse row and its cached
    activations, both dequantized (host arrays)."""
    photo: np.ndarray          # (n,)
    exit_layer: np.ndarray     # (n,)
    rows: np.ndarray           # (n, E)
    acts: np.ndarray           # (n, S, d)


def served_from_store(store, uids: np.ndarray, photo_of_uid: Dict[int, int]
                      ) -> ServedDrain:
    """Read the program's stored outputs for ``uids`` through the store's
    public accessors."""
    uids = np.asarray(uids, np.int64)
    layer_of = {e.uid: e.exit_layer for e in store.entries}
    acts = store.cached_activations(uids)
    return ServedDrain(
        photo=np.array([photo_of_uid[int(u)] for u in uids]),
        exit_layer=np.array([layer_of[int(u)] for u in uids]),
        rows=store.get_embeddings(uids),
        acts=np.stack([acts[int(u)][0] for u in uids]))


@torch.no_grad()
def standin_drain(cfg: Dict, tp: Dict, pred: Dict, photos: torch.Tensor,
                  idx: np.ndarray, prec: str) -> ServedDrain:
    """The reference in the program's place: the drain of the photos
    ``idx`` computed by the plain reference at ``prec`` (the control)."""
    exits = vision_exits(cfg)
    N = cfg["recall"]["superficial_layers"]
    uniq, inv = np.unique(idx, return_inverse=True)
    x = photos[torch.as_tensor(uniq, device=photos.device)]
    cls, h = superficial(cfg, tp, x, prec)
    choice = RP.logits(pred, cls[-1], prec).argmax(-1).cpu().numpy()
    layer = np.asarray(exits)[choice]
    emb = _exit_embeddings(cfg, tp, cls, h, layer, prec)
    rows = R4.roundtrip(emb).cpu().numpy()
    acts = R4.roundtrip(h).cpu().numpy()
    return ServedDrain(photo=idx, exit_layer=layer[inv], rows=rows[inv],
                       acts=acts[inv])


def _exit_embeddings(cfg: Dict, tp: Dict, cls: torch.Tensor,
                     h: torch.Tensor, layer: np.ndarray, prec: str
                     ) -> torch.Tensor:
    """Each photo's embedding at its exit ``layer``: from the superficial
    CLS rows where the exit lies within them, else by continuing its state
    after layer N to the exit, in groups by exit."""
    t = tower_cfg(cfg, "vision")
    N = cfg["recall"]["superficial_layers"]
    eps = cfg["norm_eps"]
    pooled = torch.empty_like(cls[0])
    for e in np.unique(layer):
        ids = np.nonzero(layer == e)[0]
        if e <= N:
            pooled[ids] = cls[e - 1][ids]
            continue
        for i in range(0, len(ids), BLOCK):
            blk = torch.as_tensor(ids[i:i + BLOCK], device=h.device)
            out = RI.tower(tp, None, h=h[blk], start=N, end=int(e),
                           n_heads=t["n_heads"], eps=eps, prec=prec)
            pooled[blk] = out["cls"][-1]
    return RL.exit_embedding(tp, pooled, eps, prec)


@torch.no_grad()
def judge_drain(cfg: Dict, tp: Dict, pred: Dict, photos: torch.Tensor,
                served: ServedDrain) -> Dict[str, float]:
    """Numbers of a drain against the float32 reference:

    * ``exit_miss``: photos whose exit is not the reference predictor's
      choice (a logit within ``TIE`` of the best counts as a choice);
    * ``emb_gap``: ``int4.cell_gap`` of the stored coarse rows against the
      reference's embeddings at the exits taken;
    * ``act_gap``: the same of the cached activations against the
      reference's state after the superficial layers."""
    exits = np.asarray(vision_exits(cfg))
    uniq, inv = np.unique(served.photo, return_inverse=True)
    x = photos[torch.as_tensor(uniq, device=photos.device)]
    cls, h = superficial(cfg, tp, x, "fp32")
    lg = RP.logits(pred, cls[-1]).cpu().numpy()
    took = np.searchsorted(exits, served.exit_layer)
    took_u = np.zeros(len(uniq), np.int64)
    took_u[inv] = took
    ok = lg[np.arange(len(uniq)), took_u] >= lg.max(-1) - TIE
    layer = np.where(ok, exits[took_u], exits[lg.argmax(-1)])
    emb = _exit_embeddings(cfg, tp, cls, h, layer, "fp32")
    dev = emb.device
    emb_gap = R4.cell_gap(emb[torch.as_tensor(inv, device=dev)],
                          torch.as_tensor(served.rows, device=dev))
    act_gap = 0.0
    for i in range(0, len(inv), BLOCK):
        sl = torch.as_tensor(inv[i:i + BLOCK], device=dev)
        act_gap = max(act_gap, R4.cell_gap(
            h[sl], torch.as_tensor(served.acts[i:i + BLOCK], device=dev)))
    return {"exit_miss": float((~ok).sum()), "emb_gap": emb_gap,
            "act_gap": act_gap}


def warm_rmsnorm(cfg: Dict, device, modalities: List[str]) -> None:
    """Compile the port's RMSNorm kernel for every row count class the
    cell's batches take (1, a multiple of 16, any other) at each width
    and type it runs, so nothing compiles in the window."""
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_op
    dt = {"vision": torch.float32, "text": torch.bfloat16}
    for m in modalities:
        d = tower_cfg(cfg, m)["d_model"]
        for rows in (1, 16, 17):
            x = torch.ones(rows, d, dtype=dt[m], device=device)
            rmsnorm_op(x, torch.ones(d, dtype=torch.bfloat16, device=device))
