"""Prompt prefill of a decoder LM: a closed loop of batches of prompts
through the port's prefill step (``launch/steps.build_step`` with a
``prefill`` shape: the layers through the flash and RMSNorm kernels, the
KV cache written at its padded size, RECALL's exit embeddings). Prompts
are seeded token ids, a pool of distinct batches made in set-up and taken
in turn.

Traffic keys: ``batch``, ``seq``, ``cache`` (the cache length, at least
``seq``), ``pool_batches``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from bench.drivers.base import Base
from bench.lib import data as D
from bench.lib import weights as W
from bench.lib.trace import span
from bench.metrics import yardstick as Y
from bench.reference import qwen2 as RQ
from bench.reference.imagebind import exit_layers


def lm_spec(cfg: Dict):
    """The port's ArchSpec of the configuration file (not registered)."""
    from repro_torch.configs.base import ArchSpec, LMConfig, RecallConfig
    model = LMConfig(
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], d_head=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        qkv_bias=cfg["qkv_bias"], rope_theta=cfg["rope_theta"],
        norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"], dtype=cfg["torch_dtype"])
    rc = RecallConfig(exit_interval=cfg["exit_interval"],
                      superficial_layers=cfg["superficial_layers"])
    return ArchSpec(arch_id=cfg["name"], family="lm", model=model,
                    shapes=(), recall=rc)


class Driver(Base):
    def setup(self) -> None:
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch.steps import build_step
        from repro_torch.models.transformer import lm_schema
        cfg, t, dev = self.cfg, self.traffic, self.device
        spec = lm_spec(cfg)
        schema = lm_schema(spec.model, spec.recall,
                           embed_out=cfg["embed_dim"])
        self.params = W.make_params(schema, seed=self.cell.seed,
                                    dtype=torch.bfloat16, device=dev)
        self.phase("weights")
        self.B, self.S = t["batch"], t["seq"]
        shape = ShapeConfig("prefill", "prefill", global_batch=self.B,
                            seq_len=self.S)
        self.step = build_step(spec, shape, device=dev,
                               pad_to=t["cache"]).fn
        self.prompts = D.token_batches(self.cell.seed, t["pool_batches"],
                                       self.B, self.S, cfg["vocab_size"],
                                       dev)
        self.phase("prompts")
        warm = self.step(self.params, self.prompts[-1])
        del warm
        self.phase("warm")
        self.rng = self.cell.rng(2)
        self.steps = 0
        self.kept = None         # (step, tokens, outputs) held for the check

    def run_window(self, win) -> None:
        n_pool = len(self.prompts) - 1     # the last batch warmed up
        while win.elapsed() < self.cell.seconds:
            tokens = self.prompts[self.steps % n_pool]
            with span("bench.prefill_step"):
                out = self.step(self.params, tokens)
            win.sync()
            # a reservoir of one: every step is equally likely to be held
            if self.rng.integers(0, self.steps + 1) == 0:
                self.kept = (self.steps, tokens, out)
            del out
            self.steps += 1

    def end_to_end(self, win) -> Dict[str, float]:
        return {"tokens_per_s": self.steps * self.B * self.S / win.seconds}

    def record(self, win) -> Dict[str, Any]:
        return {"window_s": win.seconds, "work_s": win.seconds,
                "counters": {"steps": self.steps,
                             "tokens": self.steps * self.B * self.S},
                "flops": {"bf16": self.steps
                          * Y.prefill_flops(self.cfg, self.B, self.S)}}

    def attempted_failed(self) -> tuple:
        return self.steps * self.B, 0

    def served(self):
        step, tokens, out = self.kept
        return {"tokens": tokens, "k": out["k_cache"], "v": out["v_cache"],
                "exit_embs": out["exit_embs"].float()}

    def free(self) -> None:
        self.step = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def _reference(self, tokens, prec: str, on_kv):
        cfg = self.cfg
        return RQ.prefill(self.params, tokens,
                          n_layers=cfg["num_hidden_layers"],
                          eps=cfg["rms_norm_eps"],
                          rope_theta=cfg["rope_theta"],
                          exits=exit_layers(cfg["num_hidden_layers"],
                                            cfg["exit_interval"]),
                          on_kv=on_kv, prec=prec)

    @torch.no_grad()
    def judge(self, served) -> Dict[str, float]:
        """* ``kv_err``: the worst layer's relative error of the served K
        and V caches (the prompt's rows; Frobenius norms) against the
        reference's;
        * ``exit_err``: the largest distance between a served exit
          embedding and the reference's (unit vectors)."""
        S = served["tokens"].shape[1]
        worst = [0.0]

        def on_kv(i, k, v):
            for got, want in ((served["k"][i, :, :S], k),
                              (served["v"][i, :, :S], v)):
                err = torch.linalg.vector_norm(got.float() - want)
                worst[0] = max(worst[0], float(
                    err / torch.linalg.vector_norm(want)))

        ref = self._reference(served["tokens"], "fp32", on_kv)
        exit_err = float(torch.linalg.vector_norm(
            served["exit_embs"] - ref, dim=-1).max())
        return {"kv_err": worst[0], "exit_err": exit_err}

    @torch.no_grad()
    def standin(self, prec: str):
        step, tokens, _ = self.kept
        L = self.cfg["num_hidden_layers"]
        B, S = tokens.shape
        shape = (L, B, self.traffic["cache"], self.cfg["num_key_value_heads"],
                 self.cfg["head_dim"])
        k = torch.zeros(shape, dtype=torch.bfloat16, device=self.device)
        v = torch.zeros_like(k)

        def on_kv(i, ki, vi):
            k[i, :, :S] = ki.to(torch.bfloat16)
            v[i, :, :S] = vi.to(torch.bfloat16)

        embs = self._reference(tokens, prec, on_kv)
        return {"tokens": tokens, "k": k, "v": v, "exit_embs": embs}

    def control_prec(self) -> str:
        """The step below each precision the configuration states."""
        return self.cfg["control"]["lm"]

    def notes(self) -> Dict[str, Any]:
        return {"setup_phases": self.phases, "steps": self.steps,
                "checked_step": None if self.kept is None else self.kept[0]}
