"""Prompt prefill of an MLA decoder (Moonlight-16B-A3B, DeepSeek-V3's
block): a closed loop of batches of prompts through the port's prefill
step (``launch/steps.build_step`` with a ``prefill`` shape: MLA through
the ``flash_fwd_mla`` kernel, the latent cache written at its padded
size, the dense first layer, the dropless MoE layers on the grouped
expert GEMMs, RECALL's exit embeddings). Prompts are seeded token ids, a
pool of distinct batches made in set-up and taken in turn.

Traffic keys: ``batch``, ``seq``, ``cache`` (the cache length, at least
``seq``), ``pool_batches``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from bench.drivers.base import Base
from bench.lib import data as D
from bench.lib import mla as Y
from bench.lib import weights as W
from bench.lib.trace import span
from bench.reference import moonlight as RM


def mla_spec(c: Dict):
    """The port's ArchSpec of the configuration file (not registered)."""
    from repro_torch.configs.base import (ArchSpec, MLAConfig, MLALMConfig,
                                          MoEConfig, RecallConfig,
                                          RouterConfig)
    if c["q_lora_rank"] is not None or c["scoring_func"] != "sigmoid":
        raise ValueError("the port's MLA takes q_lora_rank null and "
                         "sigmoid scoring")
    mla = MLAConfig(kv_lora_rank=c["kv_lora_rank"],
                    qk_nope_head_dim=c["qk_nope_head_dim"],
                    qk_rope_head_dim=c["qk_rope_head_dim"],
                    v_head_dim=c["v_head_dim"])
    model = MLALMConfig(
        n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_head=mla.qk_head_dim,
        d_ff=c["intermediate_size"], vocab=c["vocab_size"],
        rope_theta=float(c["rope_theta"]), norm_eps=c["rms_norm_eps"],
        tie_embeddings=c["tie_word_embeddings"], dtype=c["torch_dtype"],
        moe=MoEConfig(n_experts=c["n_routed_experts"],
                      top_k=c["num_experts_per_tok"],
                      d_ff_expert=c["moe_intermediate_size"],
                      n_shared_experts=c["n_shared_experts"]),
        mla=mla,
        router=RouterConfig(routed_scaling_factor=c["routed_scaling_factor"],
                            norm_topk_prob=c["norm_topk_prob"],
                            n_group=c["n_group"], topk_group=c["topk_group"]),
        first_k_dense=c["first_k_dense_replace"])
    rc = RecallConfig(exit_interval=c["exit_interval"],
                      superficial_layers=c["superficial_layers"])
    return ArchSpec(arch_id=c["name"], family="lm", model=model, shapes=(),
                    recall=rc)


class Driver(Base):
    def setup(self) -> None:
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch.steps import build_step
        from repro_torch.models import moe as MOE
        from repro_torch.models.transformer import lm_schema
        cfg, t, dev = self.cfg, self.traffic, self.device
        spec = mla_spec(cfg)
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
        self.moe = MOE
        self.rng = self.cell.rng(2)
        self.steps = 0
        self.kept = None         # (step, tokens, outputs) held for the check

    def run_window(self, win) -> None:
        n_pool = len(self.prompts) - 1     # the last batch warmed up
        self.moe.reset_counters()
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
        self.assignments = self.moe.counters["assignments"]

    def end_to_end(self, win) -> Dict[str, float]:
        return {"tokens_per_s": self.steps * self.B * self.S / win.seconds}

    def record(self, win) -> Dict[str, Any]:
        return {"window_s": win.seconds, "work_s": win.seconds,
                "counters": {"steps": self.steps,
                             "tokens": self.steps * self.B * self.S,
                             "assignments": self.assignments},
                "flops": {"bf16": self.steps
                          * Y.prefill_flops(self.cfg, self.B, self.S)}}

    def attempted_failed(self) -> tuple:
        return self.steps * self.B, 0

    def served(self):
        step, tokens, out = self.kept
        return {"tokens": tokens, "latent": out["latent_cache"],
                "exit_embs": out["exit_embs"].float()}

    def free(self) -> None:
        self.step = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def judge(self, served) -> Dict[str, float]:
        """* ``latent_err``: the worst layer's relative error of the served
        c_kv and k_pe (the prompt's rows of the latent cache, each part
        apart; Frobenius norms) against the reference's;
        * ``exit_err``: the largest distance between a served exit
          embedding and the reference's (unit vectors)."""
        S = served["tokens"].shape[1]
        r = self.cfg["kv_lora_rank"]
        worst = [0.0]

        def on_latent(i, ckv, k_pe):
            got = served["latent"][i, :, :S].float()
            for g, want in ((got[..., :r], ckv), (got[..., r:], k_pe)):
                err = torch.linalg.vector_norm(g - want)
                worst[0] = max(worst[0], float(
                    err / torch.linalg.vector_norm(want)))

        ref = RM.prefill(self.params, served["tokens"], self.cfg,
                         on_latent=on_latent)
        exit_err = float(torch.linalg.vector_norm(
            served["exit_embs"] - ref, dim=-1).max())
        return {"latent_err": worst[0], "exit_err": exit_err}

    @torch.no_grad()
    def standin(self, prec: str):
        step, tokens, _ = self.kept
        B, S = tokens.shape
        latent = torch.zeros((self.cfg["num_hidden_layers"], B,
                              self.traffic["cache"],
                              self.cfg["kv_lora_rank"]
                              + self.cfg["qk_rope_head_dim"]),
                             dtype=torch.bfloat16, device=self.device)
        r = self.cfg["kv_lora_rank"]

        def on_latent(i, ckv, k_pe):
            latent[i, :, :S, :r] = ckv.to(torch.bfloat16)
            latent[i, :, :S, r:] = k_pe.to(torch.bfloat16)

        embs = RM.prefill(self.params, tokens, self.cfg, on_latent=on_latent,
                          prec=prec)
        return {"tokens": tokens, "latent": latent, "exit_embs": embs}

    def control_prec(self) -> str:
        """The step below each precision the configuration states."""
        return self.cfg["control"]["lm"]

    def notes(self) -> Dict[str, Any]:
        return {"setup_phases": self.phases, "steps": self.steps,
                "checked_step": None if self.kept is None else self.kept[0],
                "max_expert_load": self.moe.read_counters()["max_load"]}
