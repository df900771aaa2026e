"""Prompt prefill of a hybrid KDA / MLA decoder (Kimi-Linear-48B-A3B): a
closed loop of batches of prompts through the port's prefill step
(``launch/steps.build_step`` with a ``prefill`` shape: the KDA layers
through the ``kernels/kda`` chunked kernel, their recurrent states and
conv tails written; the NoPE MLA layers through ``flash_fwd_mla``, the
latent cache written at its padded size; the dense first layer, the
dropless MoE layers on the grouped expert GEMMs, RECALL's exit
embeddings). Prompts are seeded token ids, a pool of distinct batches
made in set-up and taken in turn (``mla_prefill``'s loop).

Traffic keys: ``batch``, ``seq``, ``cache`` (the latent cache's length, at
least ``seq``), ``pool_batches``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from bench.drivers import mla_prefill
from bench.lib import data as D
from bench.lib import kda as K
from bench.lib import weights as W
from bench.reference import kimi_linear as RK


def kda_spec(c: Dict):
    """The port's ArchSpec of the configuration file (not registered): its
    first ``reference.kimi_linear.n_layers(c)`` layers."""
    from repro_torch.configs.base import (ArchSpec, HybridLMConfig,
                                          KDAConfig, MLAConfig, MoEConfig,
                                          RecallConfig, RouterConfig)
    if c["q_lora_rank"] is not None or \
            c["moe_router_activation_func"] != "sigmoid":
        raise ValueError("the port's MLA takes q_lora_rank null and "
                         "sigmoid routing")
    la = c["linear_attn_config"]
    mla = MLAConfig(kv_lora_rank=c["kv_lora_rank"],
                    qk_nope_head_dim=c["qk_nope_head_dim"],
                    qk_rope_head_dim=c["qk_rope_head_dim"],
                    v_head_dim=c["v_head_dim"],
                    latent_norm_eps=c["latent_norm_eps"],
                    nope=c["mla_use_nope"])
    model = HybridLMConfig(
        n_layers=RK.n_layers(c), d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_head=mla.qk_head_dim,
        d_ff=c["intermediate_size"], vocab=c["vocab_size"],
        rope_theta=float(c["rope_theta"]), norm_eps=c["rms_norm_eps"],
        tie_embeddings=c["tie_word_embeddings"], dtype=c["torch_dtype"],
        moe=MoEConfig(n_experts=c["num_experts"],
                      top_k=c["num_experts_per_token"],
                      d_ff_expert=c["moe_intermediate_size"],
                      n_shared_experts=c["num_shared_experts"]),
        mla=mla,
        router=RouterConfig(routed_scaling_factor=c["routed_scaling_factor"],
                            norm_topk_prob=c["moe_renormalize"],
                            n_group=c["num_expert_group"],
                            topk_group=c["topk_group"]),
        first_k_dense=c["first_k_dense_replace"],
        kda=KDAConfig(n_heads=la["num_heads"], head_dim=la["head_dim"],
                      conv_size=la["short_conv_kernel_size"],
                      gate_rank=c["kda_gate_rank"],
                      norm_eps=c["kda_norm_eps"]),
        kda_layers=RK.kda_layers(c))
    rc = RecallConfig(exit_interval=c["exit_interval"],
                      superficial_layers=c["superficial_layers"])
    return ArchSpec(arch_id=c["name"], family="lm", model=model, shapes=(),
                    recall=rc)


class Driver(mla_prefill.Driver):
    def setup(self) -> None:
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.kernels.kda import ops as KOPS
        from repro_torch.launch.steps import build_step
        from repro_torch.models import moe as MOE
        from repro_torch.models.transformer import lm_schema
        cfg, t, dev = self.cfg, self.traffic, self.device
        spec = kda_spec(cfg)
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
        self.moe, self.kda_ops = MOE, KOPS
        self.rng = self.cell.rng(2)
        self.steps = 0
        self.kept = None         # (step, tokens, outputs) held for the check

    def run_window(self, win) -> None:
        self.kda_ops.reset_counters()
        super().run_window(win)
        self.kda_counters = self.kda_ops.read_counters()

    def record(self, win) -> Dict[str, Any]:
        return {"window_s": win.seconds, "work_s": win.seconds,
                "counters": {"steps": self.steps,
                             "tokens": self.steps * self.B * self.S,
                             "assignments": self.assignments,
                             "kda_tokens": self.kda_counters["tokens"],
                             "kda_launches": self.kda_counters["launches"]},
                "flops": {"bf16": self.steps
                          * K.prefill_flops(self.cfg, self.B, self.S)}}

    def served(self):
        step, tokens, out = self.kept
        return {"tokens": tokens, "latent": out["latent_cache"],
                "state": out["kda_state"],
                "exit_embs": out["exit_embs"].float()}

    @torch.no_grad()
    def judge(self, served) -> Dict[str, float]:
        """* ``latent_err``: the worst MLA layer's relative error of the
        served c_kv and k_pe (the prompt's rows of the latent cache, each
        part apart; Frobenius norms) against the reference's;
        * ``state_err``: the worst KDA layer's relative error of the served
          final state (Frobenius norms) against the reference's, whose
          recurrence runs token by token;
        * ``exit_err``: the largest distance between a served exit
          embedding and the reference's (unit vectors)."""
        S = served["tokens"].shape[1]
        r = self.cfg["kv_lora_rank"]
        worst = {"latent_err": 0.0, "state_err": 0.0}

        def rel(got, want):
            return float(torch.linalg.vector_norm(got.float() - want)
                         / torch.linalg.vector_norm(want))

        def on_latent(j, ckv, k_pe):
            got = served["latent"][j, :, :S]
            for g, want in ((got[..., :r], ckv), (got[..., r:], k_pe)):
                worst["latent_err"] = max(worst["latent_err"], rel(g, want))

        def on_state(j, st):
            worst["state_err"] = max(worst["state_err"],
                                     rel(served["state"][j], st))

        ref = RK.prefill(self.params, served["tokens"], self.cfg,
                         on_latent=on_latent, on_state=on_state)
        exit_err = float(torch.linalg.vector_norm(
            served["exit_embs"] - ref, dim=-1).max())
        return {**worst, "exit_err": exit_err}

    @torch.no_grad()
    def standin(self, prec: str):
        step, tokens, out = self.kept
        B, S = tokens.shape
        latent = torch.zeros_like(out["latent_cache"])
        state = torch.zeros_like(out["kda_state"])
        r = self.cfg["kv_lora_rank"]

        def on_latent(j, ckv, k_pe):
            latent[j, :, :S, :r] = ckv.to(latent.dtype)
            latent[j, :, :S, r:] = k_pe.to(latent.dtype)

        def on_state(j, st):
            state[j] = st

        embs = RK.prefill(self.params, tokens, self.cfg, on_latent=on_latent,
                          on_state=on_state, prec=prec)
        return {"tokens": tokens, "latent": latent, "state": state,
                "exit_embs": embs}

    def notes(self) -> Dict[str, Any]:
        return {**super().notes(),
                "kda_launches": self.kda_counters["launches"]}
