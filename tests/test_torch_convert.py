"""Containers made by ``tools/convert.py`` on the port: tiny HF checkpoints
(the configurations of ``tests/test_convert.py``, built here with
``transformers`` from a seed, nothing downloaded) converted by the
unchanged converter, then the port's prefill logits (every position) and
its eager decode logits (one ``decode_step`` a token) on the CPU held to
the HF torch forward: Cohere, DBRX, Gemma, Mixtral, OLMoE, Phi-3, Qwen2, a
Llama at fp8e4, InternLM2, MiniCPM, OLMo's raw checkpoint, Xverse and
``--pad-vocab``. The port reads these within 2.3e-4 of HF's logits (fp16
weights, an f32 forward against HF's f32 one; 2.6e-2 at fp8e4's 8-bit
weights), so the tolerance is 2e-3 (0.1 at fp8e4), 25 times tighter than
``tests/test_convert.py``'s for the JAX engine, and every position's
argmax equal."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import convert as convert_mod  # noqa: E402
from calm_tpu import container as C  # noqa: E402
from calm_tpu_torch import model as TM  # noqa: E402
from calm_tpu_torch.engine import Engine  # noqa: E402

torch.set_num_threads(1)
TOKENS = [1, 10, 25, 199, 42]
TOL = 2e-3  # fp16 weights: ~10x the largest difference from HF seen
BASE = {"hidden_size": 48, "intermediate_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 268,
        "max_position_embeddings": 128, "bos_token_id": 1, "eos_token_id": 2,
        "rope_theta": 10000.0, "tie_word_embeddings": False}


def _tokenizer_json(d: Path, vocab_size: int):
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = 3 + b
    for i in range(259, vocab_size):
        vocab[f"<fill{i}>"] = i
    with open(d / "tokenizer.json", "w") as f:
        json.dump({"model": {"vocab": vocab, "merges": [], "byte_fallback": True},
                   "added_tokens": []}, f)


def _state(model) -> dict:
    return {k: v.detach().float().numpy() for k, v in model.state_dict().items()
            if "inv_freq" not in k}


def _write(d: Path, tensors: dict, config: dict, vocab: int = 268):
    C.write_tensors(str(d / "model.safetensors"), tensors, {})
    with open(d / "config.json", "w") as f:
        json.dump(config, f)
    _tokenizer_json(d, vocab)


def _hf(cls_cfg, cls_model, seed, **kw):
    torch.manual_seed(seed)
    return cls_model(cls_cfg(**kw)).eval()


def _llama(seed, **over):
    from transformers import LlamaConfig, LlamaForCausalLM
    kw = {k: v for k, v in BASE.items()}
    kw.update(rms_norm_eps=1e-5, hidden_act="silu", attention_bias=False)
    kw.update(over)
    return _hf(LlamaConfig, LlamaForCausalLM, seed, **kw)


def _simple(arch, cfg_name, model_name, seed, **over):
    """A checkpoint whose HF state dict the converter reads as it is."""
    def make(d: Path):
        import transformers
        hf = dict(BASE, **over)
        model = _hf(getattr(transformers, cfg_name), getattr(transformers, model_name), seed,
                    **hf)
        _write(d, _state(model), dict(hf, architectures=[arch]))
        return model, []
    return make


def _dbrx(d: Path):
    from transformers import DbrxConfig, DbrxForCausalLM
    hf = {"d_model": 48, "n_heads": 4, "n_layers": 2, "max_seq_len": 128, "vocab_size": 268,
          "attn_config": {"clip_qkv": 8.0, "kv_n_heads": 2, "rope_theta": 10000.0},
          "ffn_config": {"ffn_hidden_size": 64, "moe_num_experts": 4, "moe_top_k": 2}}
    model = _hf(DbrxConfig, DbrxForCausalLM, 19, **hf)
    _write(d, _state(model), dict(hf, architectures=["DbrxForCausalLM"]))
    return model, []


def _olmo_raw(d: Path):
    """OLMo's raw checkpoint, the inverse of HF's conversion of it."""
    from transformers import OlmoConfig, OlmoForCausalLM
    D, I = 48, 64
    model = _hf(OlmoConfig, OlmoForCausalLM, 23, hidden_size=D, intermediate_size=I,
                num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                vocab_size=268, max_position_embeddings=128, bos_token_id=1,
                eos_token_id=2, rope_theta=10000.0, hidden_act="silu", clip_qkv=0.5,
                tie_word_embeddings=False)
    sd = _state(model)
    raw = {"model.transformer.wte.weight": sd["model.embed_tokens.weight"],
           "model.transformer.ff_out.weight": sd["lm_head.weight"]}
    for l in range(2):
        p, b = f"model.layers.{l}", f"model.transformer.blocks.{l}"
        raw[f"{b}.att_proj.weight"] = np.concatenate(
            [sd[f"{p}.self_attn.{k}_proj.weight"] for k in "qkv"])
        raw[f"{b}.attn_out.weight"] = sd[f"{p}.self_attn.o_proj.weight"]
        raw[f"{b}.ff_proj.weight"] = np.concatenate(
            [sd[f"{p}.mlp.up_proj.weight"], sd[f"{p}.mlp.gate_proj.weight"]])
        raw[f"{b}.ff_out.weight"] = sd[f"{p}.mlp.down_proj.weight"]
    _write(d, raw, {"architectures": ["OLMoForCausalLM"], "d_model": D, "n_layers": 2,
                    "n_heads": 4, "mlp_hidden_size": 2 * I, "embedding_size": 268,
                    "max_sequence_length": 128, "eos_token_id": 2, "clip_qkv": 0.5,
                    "activation_type": "swiglu", "weight_tying": False})
    return model, []


def _internlm2(d: Path):
    """InternLM2's fused wqkv (kv head, kv_mul + 2, hd) from a Llama."""
    D, HD, NH, NKV = 48, 12, 4, 2
    model = _llama(29)
    sd = _state(model)
    kv_mul = NH // NKV
    raw = {"model.tok_embeddings.weight": sd["model.embed_tokens.weight"],
           "model.norm.weight": sd["model.norm.weight"], "output.weight": sd["lm_head.weight"]}
    for l in range(2):
        p = f"model.layers.{l}"
        q = sd[f"{p}.self_attn.q_proj.weight"].reshape(NKV, kv_mul, HD, D)
        k = sd[f"{p}.self_attn.k_proj.weight"].reshape(NKV, 1, HD, D)
        v = sd[f"{p}.self_attn.v_proj.weight"].reshape(NKV, 1, HD, D)
        raw[f"{p}.attention.wqkv.weight"] = np.concatenate([q, k, v], axis=1).reshape(
            (kv_mul + 2) * NKV * HD, D)
        raw[f"{p}.attention.wo.weight"] = sd[f"{p}.self_attn.o_proj.weight"]
        raw[f"{p}.attention_norm.weight"] = sd[f"{p}.input_layernorm.weight"]
        raw[f"{p}.ffn_norm.weight"] = sd[f"{p}.post_attention_layernorm.weight"]
        for a, b in (("w1", "gate_proj"), ("w2", "down_proj"), ("w3", "up_proj")):
            raw[f"{p}.feed_forward.{a}.weight"] = sd[f"{p}.mlp.{b}.weight"]
    _write(d, raw, dict(BASE, architectures=["InternLM2ForCausalLM"], rms_norm_eps=1e-5,
                        hidden_act="silu"))
    return model, []


def _minicpm(d: Path):
    """MiniCPM's mu-p scales on a Llama's weights; the oracle is the Llama
    with the scales folded (rmsnorm is scale-invariant)."""
    D, L = 48, 2
    s_emb, s_depth, dmb = 12.0, 1.4, 32
    rs = s_depth / (L ** 0.5)
    raw_model = _llama(31, tie_word_embeddings=True)
    sd = {k: v.copy() for k, v in _state(raw_model).items() if k != "lm_head.weight"}
    folded = _llama(31, tie_word_embeddings=True)
    folded.load_state_dict(raw_model.state_dict(), strict=False)
    with torch.no_grad():
        folded.model.embed_tokens.weight.mul_(s_emb)
        for l in range(L):
            folded.model.layers[l].self_attn.o_proj.weight.mul_(rs)
            folded.model.layers[l].mlp.down_proj.weight.mul_(rs)
        folded.model.norm.weight.mul_(dmb / D / s_emb)
    _write(d, sd, dict(BASE, architectures=["MiniCPMForCausalLM"], rms_norm_eps=1e-5,
                       hidden_act="silu", scale_emb=s_emb, scale_depth=s_depth,
                       dim_model_base=dmb, tie_word_embeddings=True))
    return folded, []


def _xverse(d: Path):
    model = _llama(17, num_key_value_heads=4)
    _write(d, _state(model), dict(BASE, architectures=["XverseForCausalLM"],
                                  num_key_value_heads=4, rms_norm_eps=1e-5, hidden_act="silu"))
    return model, []


def _llama_with(args):
    def make(d: Path):
        model = _llama(7)
        _write(d, _state(model), dict(BASE, architectures=["LlamaForCausalLM"],
                                      rms_norm_eps=1e-5, hidden_act="silu"))
        return model, args
    return make


CASES = {
    "cohere": (_simple("CohereForCausalLM", "CohereConfig", "CohereForCausalLM", 13,
                       layer_norm_eps=1e-5, logit_scale=0.125, hidden_act="silu",
                       tie_word_embeddings=True, use_qk_norm=False), TOL),
    "dbrx": (_dbrx, TOL),
    "gemma": (_simple("GemmaForCausalLM", "GemmaConfig", "GemmaForCausalLM", 9, head_dim=12,
                      rms_norm_eps=1e-5, hidden_act="gelu", tie_word_embeddings=True), TOL),
    "mixtral": (_simple("MixtralForCausalLM", "MixtralConfig", "MixtralForCausalLM", 5,
                        rms_norm_eps=1e-5, hidden_act="silu", num_local_experts=4,
                        num_experts_per_tok=2), TOL),
    "olmoe": (_simple("OlmoeForCausalLM", "OlmoeConfig", "OlmoeForCausalLM", 17,
                      rms_norm_eps=1e-5, hidden_act="silu", num_experts=4,
                      num_experts_per_tok=2, norm_topk_prob=False), TOL),
    "phi3": (_simple("Phi3ForCausalLM", "Phi3Config", "Phi3ForCausalLM", 11, pad_token_id=0,
                     rms_norm_eps=1e-5, hidden_act="silu"), TOL),
    "qwen2": (_simple("Qwen2ForCausalLM", "Qwen2Config", "Qwen2ForCausalLM", 3,
                      rms_norm_eps=1e-5, hidden_act="silu"), TOL),
    "fp8e4": (_llama_with(["--dtype", "fp8e4"]), 0.1),
    "internlm2": (_internlm2, TOL),
    "minicpm": (_minicpm, TOL),
    "olmo": (_olmo_raw, TOL),
    "xverse": (_xverse, TOL),
    "pad-vocab": (_llama_with(["--pad-vocab"]), TOL),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_converted_container_matches_hf(tmp_path, name):
    """Prefill (every position's logits) and eager decode (a step a token)
    of the converted container on the port's CPU path against the HF
    forward of the same tokens."""
    make, tol = CASES[name]
    model, args = make(tmp_path)
    out = str(tmp_path / "model.calm")
    convert_mod.main([out, str(tmp_path), "--dtype", "fp16"] + args)
    with torch.no_grad():
        want = model(torch.tensor([TOKENS])).logits[0].float().numpy()
    V = want.shape[-1]
    eng = Engine(out, context=32, kv_dtype="fp16", device="cpu")
    if name == "pad-vocab":
        assert eng.cfg.vocab_size == 384 and V == 268
    logits, _ = TM.prefill(eng.cfg, eng.weights, torch.tensor([TOKENS]), [0], eng.cache, "all")
    got = logits[0].numpy()[:, :V]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    cache = TM.KVCache.create(eng.cfg, 1, torch.float16)
    steps = np.stack([TM.decode_step(eng.cfg, eng.weights, torch.tensor([t]), p, cache)[0][0]
                      .numpy() for p, t in enumerate(TOKENS)])[:, :V]
    np.testing.assert_allclose(steps, want, rtol=tol, atol=tol)
    np.testing.assert_array_equal(steps.argmax(-1), want.argmax(-1))
