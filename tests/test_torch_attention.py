"""The LM stack's attention kinds (``models/attention.py``: GQA and MLA)
held to pins: ``lm_schema``'s leaves for every LM arch ``configs.base``
registers (the port's own ones too) and their smoke variants, and the
bits of a prefill plus two greedy decode steps of every smoke variant on
the CPU. ``tests/test_torch_attention_pins.json`` holds both;
``python tests/test_torch_attention.py`` writes it afresh, which only a
deliberate change of the trees or of the steps' arithmetic calls for.
Also: an MLA layer refuses a LoRA at prefill and at decode."""
import hashlib
import json
from pathlib import Path

import pytest
import torch

from repro_torch.configs import base as TC
from repro_torch.launch.steps import build_step
from repro_torch.models.transformer import lm_init, lm_schema

PINS = Path(__file__).with_name("test_torch_attention_pins.json")
ARCHS = [a for a in TC.list_archs() + TC.port_archs()
         if TC.get_arch(a).family == "lm"]
B, S = 2, 8


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(arch: str, smoke: bool) -> TC.ArchSpec:
    spec = TC.get_arch(arch)
    return TC.smoke_variant(spec) if smoke else spec


def schema_leaves(arch: str, smoke: bool) -> list:
    """[[path, shape, axes, init, scale]] of ``lm_schema``, in its order."""
    out = []

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                out.append(["/".join(path + (k,)), list(v.shape),
                            list(v.axes), v.init, v.scale])
    spec = _spec(arch, smoke)
    walk(lm_schema(spec.model, spec.recall), ())
    return out


def _digest(t: torch.Tensor) -> str:
    t = t.detach().cpu().contiguous()
    h = hashlib.sha256(t.numpy().tobytes()).hexdigest()[:32]
    return f"{tuple(t.shape)} {t.dtype} {h}"


def step_digests(arch: str) -> dict:
    """Digests of a smoke variant's prefill of (2, 8) seeded tokens into a
    10-row cache (its caches and exit embeddings), then of two greedy
    ``build_step`` decode steps (logits, then the caches after both)."""
    spec = _spec(arch, True)
    params = lm_init(torch.Generator().manual_seed(0), spec.model,
                     spec.recall, device="cpu")
    tokens = torch.randint(0, spec.model.vocab, (B, S),
                           generator=torch.Generator().manual_seed(1))
    pre = build_step(spec, TC.ShapeConfig("p", "prefill", B, S),
                     device="cpu", pad_to=S + 2).fn
    dec = build_step(spec, TC.ShapeConfig("d", "decode", B, S + 2),
                     device="cpu").fn
    with torch.no_grad():
        out = pre(params, tokens)
        got = {k: _digest(v) for k, v in out.items()}
        caches = [v for k, v in out.items() if k != "exit_embs"]
        token = tokens[:, -1]
        for i in range(2):
            lengths = torch.full((B,), S + i + 1, dtype=torch.int32)
            logits, *caches = dec(params, token, *caches, lengths)
            got[f"logits_{i}"] = _digest(logits)
            token = logits.argmax(-1)
        for k, c in zip(out, caches):
            got[f"{k}_after"] = _digest(c)
    return got


def _pins() -> dict:
    return json.loads(PINS.read_text())


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_schema_leaves_match_the_pins(arch, smoke):
    key = arch + ("-smoke" if smoke else "")
    assert schema_leaves(arch, smoke) == _pins()["schema"][key]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_two_decode_steps_match_the_pinned_bits(arch):
    assert step_digests(arch) == _pins()["steps"][arch]


def _lora_on_attention(spec):
    """A one-layer LoRA tree on ``wo`` shaped as ``core/plora``'s GQA
    target, for an MLA config that has no such target."""
    m = spec.model
    a = torch.zeros(m.n_layers, m.n_heads * m.mla.v_head_dim, 4)
    return {"wo": {"a": a, "b": torch.zeros(m.n_layers, 4, m.d_model)}}


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_mla_layer_refuses_a_lora(step):
    from repro_torch.models import transformer as T
    spec = _spec("moonlight-16b-a3b", True)
    m = spec.model
    params = lm_init(torch.Generator().manual_seed(0), m, spec.recall,
                     device="cpu")
    tokens = torch.randint(0, m.vocab, (B, S),
                           generator=torch.Generator().manual_seed(1))
    lora = _lora_on_attention(spec)
    with pytest.raises(NotImplementedError, match="LoRA"):
        if step == "prefill":
            T.prefill(params, m, spec.recall, tokens, lora=lora)
        else:
            caches = T.prefill(params, m, spec.recall, tokens,
                               pad_to=S + 1)["latent_cache"]
            T.decode_step(params, m, spec.recall, tokens[:, -1], caches,
                          torch.full((B,), S + 1, dtype=torch.int32),
                          lora=lora)


if __name__ == "__main__":
    def rows(d):   # one leaf or one digest a line
        return ",\n".join(f"  {json.dumps(k)}: [\n   " + ",\n   ".join(
            json.dumps(x) for x in v) + "]" if isinstance(v, list)
            else f"  {json.dumps(k)}: {json.dumps(v, indent=3)[:-1]}  }}"
            for k, v in d.items())
    schema = {a + ("-smoke" if s else ""): schema_leaves(a, s)
              for a in ARCHS for s in (False, True)}
    steps = {a: step_digests(a) for a in ARCHS}
    PINS.write_text('{"schema": {\n' + rows(schema) + '},\n"steps": {\n'
                    + rows(steps) + "}}\n")
