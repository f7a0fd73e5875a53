"""HF checkpoint -> .calm container converter + quantizer (the port of
``tools/convert.py``).

The reference converter's metadata schema, tensor-name schema (``model.*``
+ ``tokenizer.*``) and formats (fp16 / fp8-e5m2 / fp8e4 / gf4), in numpy
and torch over the port's ``container`` and ``quant``, with no JAX and no
``ml_dtypes``: the container it writes is ``tools/convert.py``'s, byte for
byte (the same names, tags, shapes, bytes and metadata). ``--pad-vocab``
rounds the vocab up to a multiple of 128 so that the lm-head shards
cleanly over a mesh. It runs on the host and needs no GPU.

The port's ``TensorFile`` hands ``BF16`` out as ``uint16`` and 8-bit
floats as ``uint8``: such tensors are read as torch ``bfloat16`` /
``float8`` views of the file's pages (:func:`load_hf_weights`), which
:func:`to_f32` widens exactly, as ml_dtypes' arrays are. A ``.bin``
checkpoint is read by ``torch.load``; ``sentencepiece`` (a ``.model``
tokenizer) is imported only when one is given.

Usage:
  python -m calm_tpu_torch.tools.convert out.calm <hf_model_dir> [--dtype fp16|fp8|fp8e4|gf4]
  python -m calm_tpu_torch.tools.convert out.calm --config config.json \\
      --tokenizer tok.json --models a.safetensors b.safetensors [--dtype fp8]
"""

from __future__ import annotations

import argparse
import base64
import json
import os

import numpy as np
import torch

from calm_tpu_torch import container, quant

# HF architecture class -> calm arch tag (reference schema: metadata "arch")
ARCH_REMAP = {
    "LlamaForCausalLM": "llama",
    "MistralForCausalLM": "mistral",
    "MixtralForCausalLM": "mixtral",
    "Qwen2ForCausalLM": "qwen2",
    "OLMoForCausalLM": "olmo",
    "GemmaForCausalLM": "gemma",
    "MiniCPMForCausalLM": "minicpm",
    "CohereForCausalLM": "cohere",
    "InternLM2ForCausalLM": "internlm2",
    "DbrxForCausalLM": "dbrx",
    "XverseForCausalLM": "xverse",
    "Phi3ForCausalLM": "phi3",
    "OlmoeForCausalLM": "olmoe",
}

HF_FAMILY = ("llama", "mistral", "mixtral", "qwen2", "gemma", "minicpm",
             "cohere", "internlm2", "xverse", "phi3", "olmoe")


# ---------------------------------------------------------------------------
# metadata extraction
# ---------------------------------------------------------------------------

def extract_metadata(arch: str, config: dict, dtype: str) -> dict:
    md = {"arch": arch, "dtype": dtype}
    if arch in HF_FAMILY:
        md["dim"] = config["hidden_size"]
        md["hidden_dim"] = config["intermediate_size"]
        md["head_dim"] = config.get("head_dim") or config["hidden_size"] // config["num_attention_heads"]
        md["n_layers"] = config["num_hidden_layers"]
        md["n_heads"] = config["num_attention_heads"]
        md["n_kv_heads"] = config.get("num_key_value_heads", config["num_attention_heads"])
        md["vocab_size"] = config["vocab_size"]
        md["max_seq_len"] = 2048 if arch == "phi3" else config["max_position_embeddings"]
        md["bos_token_id"] = -1 if arch in ("qwen2", "olmoe") else config["bos_token_id"]
        md["eos_token_id"] = config["eos_token_id"]
        md["rope_theta"] = config.get("rope_theta", 10000.0)
        md["rotary_dim"] = int(md["head_dim"] * config.get("partial_rotary_factor", 1))
        md["norm_eps"] = config["layer_norm_eps"] if arch == "cohere" else config["rms_norm_eps"]
        md["norm_type"] = "layernorm_par" if arch == "cohere" else "rmsnorm"
        assert config["hidden_act"] in ("gelu", "silu"), config["hidden_act"]
        md["act_type"] = config["hidden_act"]
        if arch == "mixtral":
            md["n_experts"] = config["num_local_experts"]
            md["n_experts_active"] = config["num_experts_per_tok"]
        elif arch in ("minicpm", "olmoe") and config.get("num_experts"):
            md["n_experts"] = config["num_experts"]
            md["n_experts_active"] = config["num_experts_per_tok"]
        if arch == "olmoe":
            # OLMoE RMSNorms the full q/k projections; the reference skips
            # this with a warning (reference tools/convert.py:315) — we carry
            # the norm weights so the engine matches the HF forward exactly
            md["norm_qk"] = 1
            if not config.get("norm_topk_prob", False):
                md["moe_renorm"] = 0  # gate probs NOT renormalized over top-k
    elif arch == "olmo":
        md["dim"] = config["d_model"]
        md["hidden_dim"] = (config["mlp_hidden_size"] or config["d_model"] * config["mlp_ratio"]) // 2
        md["head_dim"] = config["d_model"] // config["n_heads"]
        md["n_layers"] = config["n_layers"]
        md["n_heads"] = config["n_heads"]
        md["n_kv_heads"] = config["n_heads"]
        md["vocab_size"] = config["embedding_size"]
        md["max_seq_len"] = config["max_sequence_length"]
        md["bos_token_id"] = -1
        md["eos_token_id"] = config["eos_token_id"]
        md["rope_theta"] = 10000.0
        md["rotary_dim"] = config["d_model"] // config["n_heads"]
        md["norm_eps"] = 1e-5
        md["norm_type"] = "layernorm"
        assert config["activation_type"] == "swiglu"
        md["act_type"] = "silu"
        if config.get("clip_qkv"):
            md["qkv_clip"] = config["clip_qkv"]
    elif arch == "dbrx":
        md["dim"] = config["d_model"]
        md["hidden_dim"] = config["ffn_config"]["ffn_hidden_size"]
        md["head_dim"] = config["d_model"] // config["n_heads"]
        md["n_layers"] = config["n_layers"]
        md["n_heads"] = config["n_heads"]
        md["n_kv_heads"] = config["attn_config"]["kv_n_heads"]
        md["vocab_size"] = config["vocab_size"]
        md["max_seq_len"] = config["max_seq_len"]
        md["bos_token_id"] = -1
        md["eos_token_id"] = 100257
        md["rope_theta"] = config["attn_config"]["rope_theta"]
        md["rotary_dim"] = config["d_model"] // config["n_heads"]
        md["norm_eps"] = 1e-5
        md["norm_type"] = "layernorm"
        md["act_type"] = "silu"
        md["n_experts"] = config["ffn_config"]["moe_num_experts"]
        md["n_experts_active"] = config["ffn_config"]["moe_top_k"]
        md["qkv_clip"] = config["attn_config"]["clip_qkv"]
    else:
        raise SystemExit(f"unsupported arch {arch}")
    return md


# ---------------------------------------------------------------------------
# tokenizer ingestion
# ---------------------------------------------------------------------------

def gpt2_unicode_to_bytes() -> dict:
    """Inverse of GPT-2's bytes<->unicode mangling (poisons all HF ByteLevel
    tokenizers; tokens must be un-mangled back to raw bytes)."""
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(ord("¡"), ord("¬") + 1)) +
          list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


def load_tokenizer(path: str, vocab_size: int, config: dict):
    """Return (pieces: list[bytes], scores: np.float32[vocab])."""
    tokens = [""] * vocab_size
    scores = np.zeros(vocab_size, dtype=np.float32)
    gpt2_style = False

    ext = os.path.splitext(path)[1]
    if ext == ".json":
        with open(path, "r", encoding="utf-8") as f:
            tok = json.load(f)
        vocab = tok["model"]["vocab"]
        assert len(vocab) <= vocab_size
        gpt2_style = not tok["model"].get("byte_fallback", False)
        for t, i in vocab.items():
            tokens[i] = t
        for added in tok.get("added_tokens", []):
            tokens[added["id"]] = added["content"]
        # merge rank -> negative score so earlier merges win
        for i, m in enumerate(tok["model"].get("merges", [])):
            t1, t2 = (m[0], m[1]) if isinstance(m, list) else m.split(" ", 1)
            ti = vocab[t1 + t2]
            if scores[ti] == 0:
                scores[ti] = -(1 + i)
    elif ext == ".model":
        import sentencepiece
        sp = sentencepiece.SentencePieceProcessor(model_file=path)
        assert sp.vocab_size() <= vocab_size
        for i in range(sp.vocab_size()):
            tokens[i] = sp.id_to_piece(i)
            scores[i] = sp.get_score(i)
    elif ext == ".tiktoken":
        with open(path, "r") as f:
            lines = f.readlines()
        assert len(lines) <= vocab_size
        for i, l in enumerate(lines):
            t, r = l.rstrip().split(" ")
            tokens[i] = base64.b64decode(t).decode("utf-8", errors="replace").replace("\0", "\7")
            scores[i] = -int(r)
    else:
        raise SystemExit(f"unknown tokenizer extension {ext}")

    g2b = gpt2_unicode_to_bytes()
    pieces = []
    for t in tokens:
        if gpt2_style:
            b = bytes(g2b.get(c, 0) for c in t)
        else:
            b = t.replace("▁", " ").encode("utf-8")
        b = b.replace(b"\0", b"\x07")  # container uses NUL separators
        pieces.append(b)
    return pieces, scores


# ---------------------------------------------------------------------------
# weight loading / transforms
# ---------------------------------------------------------------------------

def load_hf_weights(files: list[str]) -> dict:
    """name -> array over every file: numpy views of the safetensors pages
    (torch ``bfloat16``/``float8`` views where numpy has no such type) or
    the ``.bin`` file's torch tensors."""
    weights = {}
    for fn in files:
        ext = os.path.splitext(fn)[1]
        if ext == ".safetensors":
            tf = container.TensorFile(fn)
            for k in tf.names():
                assert k not in weights, k
                tag, _ = tf.find(k)
                a = tf.get(k)
                if tag in ("BF16", "F8_E5M2", "F8_E4M3"):  # read-only: never written
                    a = container.to_torch_view(a, tag)
                weights[k] = a
        elif ext == ".bin":
            pth = torch.load(fn, map_location="cpu", weights_only=True)
            for k, v in pth.items():
                assert k not in weights, k
                weights[k] = v
        else:
            raise SystemExit(f"unknown model file extension {ext}")
    return weights


def to_f32(a) -> np.ndarray:
    """f32 of an array or a torch tensor (bf16 and 8-bit floats widen
    exactly)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def permute_reverse(w: np.ndarray, heads: int, rotary_dim: int) -> np.ndarray:
    """Undo HF's two-half Q/K head layout so RoPE rotates interleaved pairs.

    HF stores each head's rotary outputs as [first halves..., second
    halves...]; the engine wants (even, odd) interleaved. Inverse of
    transformers' convert_llama_weights_to_hf permutation.
    """
    shape = w.shape
    head_dim = shape[0] // heads
    assert rotary_dim <= head_dim
    w = w.reshape(heads, head_dim, -1)
    wr, wk = w[:, :rotary_dim], w[:, rotary_dim:]
    wr = wr.reshape(heads, 2, rotary_dim // 2, -1).transpose(0, 2, 1, 3)
    wr = wr.reshape(heads, rotary_dim, -1)
    return np.concatenate([wr, wk], axis=1).reshape(shape)


class _TensorDict(dict):
    """Tensor sink that splits quantize_scaled's (codes, scale) pairs into
    ``name`` + ``name.scale`` container entries (fp8e4's per-tensor scale
    rides alongside its weight; other formats carry scale None)."""

    def __setitem__(self, k, v):
        if isinstance(v, tuple):
            q, s = v
            super().__setitem__(k, q)
            if s is not None:
                super().__setitem__(k + ".scale", s)
        else:
            super().__setitem__(k, v)


class Converter:
    def __init__(self, dtype: str):
        self.dtype = dtype
        self.tensors: dict = _TensorDict()
        self.progress = 0

    def _quantize(self, a):
        self.progress += 1
        print(f"\rconverting tensor {self.progress}: {tuple(a.shape)}",
              end="", flush=True)
        return quant.quantize_scaled(to_f32(a), self.dtype)

    def conv(self, a):
        q, s = self._quantize(a)
        return quant.container_codes(q, self.dtype), s

    def conv_stack(self, arrs):
        qs, ss = zip(*[self._quantize(a) for a in arrs])
        return (quant.container_codes(np.stack(qs), self.dtype),
                np.stack(ss) if ss[0] is not None else None)


def convert_weights(cv: Converter, arch: str, config: dict, md: dict,
                    weights: dict) -> dict:
    t = cv.tensors
    n_layers = md["n_layers"]

    # model-specific preprocessing: fold scales into weights so the engine
    # stays scale-free
    if arch == "minicpm":
        embed_scale = config["scale_emb"]
        resid_scale = config["scale_depth"] / (config["num_hidden_layers"] ** 0.5)
        final_scale = config["dim_model_base"] / config["hidden_size"]
        tied_div = 1.0 if config.get("tie_word_embeddings") is False else embed_scale
        weights["model.norm.weight"] = to_f32(weights["model.norm.weight"]) * (final_scale / tied_div)
        weights["model.embed_tokens.weight"] = to_f32(weights["model.embed_tokens.weight"]) * embed_scale
        for l in range(n_layers):
            k = f"model.layers.{l}.self_attn.o_proj.weight"
            weights[k] = to_f32(weights[k]) * resid_scale
            if config.get("num_experts"):
                for e in range(config["num_experts"]):
                    k = f"model.layers.{l}.mlp.experts.{e}.w2.weight"
                    weights[k] = to_f32(weights[k]) * resid_scale
            else:
                k = f"model.layers.{l}.mlp.down_proj.weight"
                weights[k] = to_f32(weights[k]) * resid_scale
    elif arch == "gemma":
        # norm weights are relative to 1.0; fold the sqrt(dim) embed scale in
        # (and counter it in the final norm since output weights are tied)
        for name in (["model.norm.weight"] +
                     [f"model.layers.{l}.{n}" for l in range(n_layers)
                      for n in ("input_layernorm.weight", "post_attention_layernorm.weight")]):
            weights[name] = to_f32(weights[name]) + 1.0
        embed_scale = config["hidden_size"] ** 0.5
        weights["model.norm.weight"] = to_f32(weights["model.norm.weight"]) / embed_scale
        weights["model.embed_tokens.weight"] = to_f32(weights["model.embed_tokens.weight"]) * embed_scale
    elif arch == "cohere":
        weights["model.norm.weight"] = to_f32(weights["model.norm.weight"]) * config["logit_scale"]

    rotary_dim = md["rotary_dim"]
    head_dim = md["head_dim"]
    n_heads = md["n_heads"]
    n_kv_heads = md["n_kv_heads"]

    # weight-name families: internlm2/phi3 share the HF metadata schema but
    # carry fused/renamed tensors, handled in their own branches below
    if arch in ("llama", "mistral", "mixtral", "qwen2", "gemma", "minicpm",
                "cohere", "xverse", "olmoe"):
        t["model.embed.weight"] = cv.conv(weights["model.embed_tokens.weight"])
        for l in range(n_layers):
            p = f"model.layers.{l}"
            t[f"{p}.attn.norm.weight"] = to_f32(weights[f"{p}.input_layernorm.weight"])
            wq = to_f32(weights[f"{p}.self_attn.q_proj.weight"])
            wk = to_f32(weights[f"{p}.self_attn.k_proj.weight"])
            if arch != "cohere":  # cohere uses non-interleaved rope upstream
                wq = permute_reverse(wq, n_heads, rotary_dim)
                wk = permute_reverse(wk, n_kv_heads, rotary_dim)
            t[f"{p}.attn.wq.weight"] = cv.conv(wq)
            t[f"{p}.attn.wk.weight"] = cv.conv(wk)
            t[f"{p}.attn.wv.weight"] = cv.conv(weights[f"{p}.self_attn.v_proj.weight"])
            t[f"{p}.attn.wo.weight"] = cv.conv(weights[f"{p}.self_attn.o_proj.weight"])

            if arch == "qwen2":
                t[f"{p}.attn.wqkv.bias"] = np.concatenate([
                    permute_reverse(to_f32(weights[f"{p}.self_attn.q_proj.bias"]), n_heads, rotary_dim),
                    permute_reverse(to_f32(weights[f"{p}.self_attn.k_proj.bias"]), n_kv_heads, rotary_dim),
                    to_f32(weights[f"{p}.self_attn.v_proj.bias"]),
                ])

            if arch == "olmoe":
                # q/k norm weights ride permuted like their projection rows
                # (the mean-square is permutation-invariant, so RMSNorm on the
                # permuted vector with the permuted weight is exact)
                qn = to_f32(weights[f"{p}.self_attn.q_norm.weight"])
                kn = to_f32(weights[f"{p}.self_attn.k_norm.weight"])
                t[f"{p}.attn.q_norm.weight"] = permute_reverse(
                    qn.reshape(-1, 1), n_heads, rotary_dim).reshape(-1)
                t[f"{p}.attn.k_norm.weight"] = permute_reverse(
                    kn.reshape(-1, 1), n_kv_heads, rotary_dim).reshape(-1)

            if arch != "cohere":
                t[f"{p}.mlp.norm.weight"] = to_f32(weights[f"{p}.post_attention_layernorm.weight"])

            if arch == "mixtral":
                t[f"{p}.moegate.weight"] = cv.conv(weights[f"{p}.block_sparse_moe.gate.weight"])
                E = config["num_local_experts"]
                for w_out, w_in in (("w1", "w1"), ("w2", "w2"), ("w3", "w3")):
                    t[f"{p}.mlp.{w_out}.weight"] = cv.conv_stack(
                        weights[f"{p}.block_sparse_moe.experts.{e}.{w_in}.weight"] for e in range(E))
            elif arch == "minicpm" and config.get("num_experts"):
                t[f"{p}.moegate.weight"] = cv.conv(weights[f"{p}.mlp.gate.weight"])
                E = config["num_experts"]
                for w in ("w1", "w2", "w3"):
                    t[f"{p}.mlp.{w}.weight"] = cv.conv_stack(
                        weights[f"{p}.mlp.experts.{e}.{w}.weight"] for e in range(E))
            elif arch == "olmoe":
                t[f"{p}.moegate.weight"] = cv.conv(weights[f"{p}.mlp.gate.weight"])
                E = config["num_experts"]
                for w_out, w_in in (("w1", "gate_proj"), ("w2", "down_proj"), ("w3", "up_proj")):
                    t[f"{p}.mlp.{w_out}.weight"] = cv.conv_stack(
                        weights[f"{p}.mlp.experts.{e}.{w_in}.weight"] for e in range(E))
            else:
                t[f"{p}.mlp.w1.weight"] = cv.conv(weights[f"{p}.mlp.gate_proj.weight"])
                t[f"{p}.mlp.w2.weight"] = cv.conv(weights[f"{p}.mlp.down_proj.weight"])
                t[f"{p}.mlp.w3.weight"] = cv.conv(weights[f"{p}.mlp.up_proj.weight"])

        t["model.norm.weight"] = to_f32(weights["model.norm.weight"])
        if config.get("tie_word_embeddings") is not True:
            t["model.output.weight"] = cv.conv(weights["lm_head.weight"])

    elif arch == "internlm2":
        t["model.embed.weight"] = cv.conv(weights["model.tok_embeddings.weight"])
        kv_mul = n_heads // n_kv_heads
        for l in range(n_layers):
            p = f"model.layers.{l}"
            t[f"{p}.attn.norm.weight"] = to_f32(weights[f"{p}.attention_norm.weight"])
            wqkv = to_f32(weights[f"{p}.attention.wqkv.weight"])
            wqkv = wqkv.reshape(n_kv_heads, kv_mul + 2, head_dim, -1)
            wq = wqkv[:, :kv_mul].reshape(n_heads * head_dim, -1)
            wk = wqkv[:, kv_mul].reshape(n_kv_heads * head_dim, -1)
            wv = wqkv[:, kv_mul + 1].reshape(n_kv_heads * head_dim, -1)
            t[f"{p}.attn.wq.weight"] = cv.conv(permute_reverse(wq, n_heads, head_dim))
            t[f"{p}.attn.wk.weight"] = cv.conv(permute_reverse(wk, n_kv_heads, head_dim))
            t[f"{p}.attn.wv.weight"] = cv.conv(wv)
            t[f"{p}.attn.wo.weight"] = cv.conv(weights[f"{p}.attention.wo.weight"])
            t[f"{p}.mlp.norm.weight"] = to_f32(weights[f"{p}.ffn_norm.weight"])
            t[f"{p}.mlp.w1.weight"] = cv.conv(weights[f"{p}.feed_forward.w1.weight"])
            t[f"{p}.mlp.w2.weight"] = cv.conv(weights[f"{p}.feed_forward.w2.weight"])
            t[f"{p}.mlp.w3.weight"] = cv.conv(weights[f"{p}.feed_forward.w3.weight"])
        t["model.norm.weight"] = to_f32(weights["model.norm.weight"])
        t["model.output.weight"] = cv.conv(weights["output.weight"])

    elif arch == "olmo":
        dim = config["d_model"]
        hidden_dim = md["hidden_dim"]
        t["model.embed.weight"] = cv.conv(weights["model.transformer.wte.weight"])
        for l in range(n_layers):
            p = f"model.layers.{l}"
            t[f"{p}.attn.norm.weight"] = np.ones(dim, np.float32)
            attn_proj = to_f32(weights[f"model.transformer.blocks.{l}.att_proj.weight"])
            assert attn_proj.shape == (dim * 3, dim)
            t[f"{p}.attn.wq.weight"] = cv.conv(permute_reverse(attn_proj[:dim], n_heads, head_dim))
            t[f"{p}.attn.wk.weight"] = cv.conv(permute_reverse(attn_proj[dim:2 * dim], n_heads, head_dim))
            t[f"{p}.attn.wv.weight"] = cv.conv(attn_proj[2 * dim:])
            t[f"{p}.attn.wo.weight"] = cv.conv(weights[f"model.transformer.blocks.{l}.attn_out.weight"])
            t[f"{p}.attn.norm.weight"] = np.ones(dim, np.float32)
            t[f"{p}.mlp.norm.weight"] = np.ones(dim, np.float32)
            mlp_proj = to_f32(weights[f"model.transformer.blocks.{l}.ff_proj.weight"])
            assert mlp_proj.shape == (hidden_dim * 2, dim)
            t[f"{p}.mlp.w1.weight"] = cv.conv(mlp_proj[hidden_dim:])
            t[f"{p}.mlp.w2.weight"] = cv.conv(weights[f"model.transformer.blocks.{l}.ff_out.weight"])
            t[f"{p}.mlp.w3.weight"] = cv.conv(mlp_proj[:hidden_dim])
        t["model.norm.weight"] = np.ones(dim, np.float32)
        if not config["weight_tying"]:
            t["model.output.weight"] = cv.conv(weights["model.transformer.ff_out.weight"])

    elif arch == "dbrx":
        dim = config["d_model"]
        hidden_dim = md["hidden_dim"]
        E = md["n_experts"]
        t["model.embed.weight"] = cv.conv(weights["transformer.wte.weight"])
        for l in range(n_layers):
            p = f"model.layers.{l}"
            b = f"transformer.blocks.{l}"
            t[f"{p}.attn.norm.weight"] = to_f32(weights[f"{b}.norm_attn_norm.norm_1.weight"])
            wqkv = to_f32(weights[f"{b}.norm_attn_norm.attn.Wqkv.weight"])
            q_end, k_end = n_heads * head_dim, (n_heads + n_kv_heads) * head_dim
            t[f"{p}.attn.wq.weight"] = cv.conv(permute_reverse(wqkv[:q_end], n_heads, head_dim))
            t[f"{p}.attn.wk.weight"] = cv.conv(permute_reverse(wqkv[q_end:k_end], n_kv_heads, head_dim))
            t[f"{p}.attn.wv.weight"] = cv.conv(wqkv[k_end:])
            t[f"{p}.attn.wo.weight"] = cv.conv(weights[f"{b}.norm_attn_norm.attn.out_proj.weight"])
            t[f"{p}.mlp.norm.weight"] = to_f32(weights[f"{b}.norm_attn_norm.norm_2.weight"])
            t[f"{p}.moegate.weight"] = cv.conv(weights[f"{b}.ffn.router.layer.weight"])
            w1 = to_f32(weights[f"{b}.ffn.experts.mlp.w1"]).reshape(E, hidden_dim, dim)
            w2 = to_f32(weights[f"{b}.ffn.experts.mlp.w2"]).reshape(E, hidden_dim, dim)
            v1 = to_f32(weights[f"{b}.ffn.experts.mlp.v1"]).reshape(E, hidden_dim, dim)
            t[f"{p}.mlp.w1.weight"] = cv.conv_stack(w1)
            t[f"{p}.mlp.w2.weight"] = cv.conv_stack(w2.transpose(0, 2, 1))
            t[f"{p}.mlp.w3.weight"] = cv.conv_stack(v1)
        t["model.norm.weight"] = to_f32(weights["transformer.norm_f.weight"])
        t["model.output.weight"] = cv.conv(weights["lm_head.weight"])

    elif arch == "phi3":
        hidden_dim = md["hidden_dim"]
        t["model.embed.weight"] = cv.conv(weights["model.embed_tokens.weight"])
        for l in range(n_layers):
            p = f"model.layers.{l}"
            t[f"{p}.attn.norm.weight"] = to_f32(weights[f"{p}.input_layernorm.weight"])
            wqkv = to_f32(weights[f"{p}.self_attn.qkv_proj.weight"])
            q_end, k_end = n_heads * head_dim, (n_heads + n_kv_heads) * head_dim
            t[f"{p}.attn.wq.weight"] = cv.conv(permute_reverse(wqkv[:q_end], n_heads, head_dim))
            t[f"{p}.attn.wk.weight"] = cv.conv(permute_reverse(wqkv[q_end:k_end], n_kv_heads, head_dim))
            t[f"{p}.attn.wv.weight"] = cv.conv(wqkv[k_end:])
            t[f"{p}.attn.wo.weight"] = cv.conv(weights[f"{p}.self_attn.o_proj.weight"])
            t[f"{p}.mlp.norm.weight"] = to_f32(weights[f"{p}.post_attention_layernorm.weight"])
            mlp_proj = to_f32(weights[f"{p}.mlp.gate_up_proj.weight"])
            t[f"{p}.mlp.w1.weight"] = cv.conv(mlp_proj[:hidden_dim])
            t[f"{p}.mlp.w2.weight"] = cv.conv(weights[f"{p}.mlp.down_proj.weight"])
            t[f"{p}.mlp.w3.weight"] = cv.conv(mlp_proj[hidden_dim:])
        t["model.norm.weight"] = to_f32(weights["model.norm.weight"])
        t["model.output.weight"] = cv.conv(weights["lm_head.weight"])

    return t


def convert(output: str, config: dict, tokenizer_path: str,
            model_files: list[str], dtype: str = "fp8",
            pad_vocab: bool = False) -> None:
    arch = config["architectures"][0]
    if arch not in ARCH_REMAP:
        raise SystemExit(f"unsupported architecture {arch}; known: {list(ARCH_REMAP)}")
    arch = ARCH_REMAP[arch]

    md = extract_metadata(arch, config, dtype)
    pieces, scores = load_tokenizer(tokenizer_path, md["vocab_size"], config)
    weights = load_hf_weights(model_files)

    if pad_vocab and md["vocab_size"] % 128:
        # round the vocab to a lane-aligned multiple of 128 so the lm_head
        # and embedding shard cleanly over a mesh: zero embedding rows,
        # empty never-matching tokenizer pieces with -inf-ish scores
        v_old = md["vocab_size"]
        v_new = (v_old + 127) // 128 * 128
        md["vocab_size"] = v_new
        pieces = pieces + [b""] * (v_new - v_old)
        scores = np.concatenate([scores,
                                 np.full(v_new - v_old, -1e9, np.float32)])
        pad = v_new - v_old

        def pad_rows(name):
            if name in weights:
                w = to_f32(weights[name])
                weights[name] = np.concatenate(
                    [w, np.zeros((pad, w.shape[1]), np.float32)])
        pad_rows("model.embed_tokens.weight")
        pad_rows("model.tok_embeddings.weight")
        pad_rows("model.transformer.wte.weight")
        pad_rows("transformer.wte.weight")
        pad_rows("lm_head.weight")
        pad_rows("output.weight")
        pad_rows("model.transformer.ff_out.weight")
        print(f"padded vocab {v_old} -> {v_new}")

    cv = Converter(dtype)
    tensors = convert_weights(cv, arch, config, md, weights)

    # tokenizer tensors go last to keep the big weights aligned
    tensors["tokenizer.tokens"] = np.frombuffer(
        b"".join(p + b"\0" for p in pieces), dtype=np.uint8)
    tensors["tokenizer.scores"] = scores

    print(f"\rsaving {len(tensors)} tensors" + " " * 40)
    container.write_tensors(output, tensors, {k: str(v) for k, v in md.items()})


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m calm_tpu_torch.tools.convert")
    ap.add_argument("output")
    ap.add_argument("input", nargs="?")
    ap.add_argument("--config")
    ap.add_argument("--tokenizer")
    ap.add_argument("--models", nargs="+")
    ap.add_argument("--dtype", default="fp8",
                    choices=["fp16", "fp8", "fp8e4", "gf4"])
    ap.add_argument("--pad-vocab", action="store_true",
                    help="round vocab up to a multiple of 128 so embed/"
                         "lm_head shard cleanly over a TPU mesh")
    args = ap.parse_args(argv)

    if args.input is not None:
        if args.config is None:
            args.config = os.path.join(args.input, "config.json")
        if args.tokenizer is None:
            for cand in ("tokenizer.json", "tokenizer.model"):
                p = os.path.join(args.input, cand)
                if os.path.exists(p):
                    args.tokenizer = p
                    break
        if args.models is None:
            files = sorted(os.listdir(args.input))
            args.models = [os.path.join(args.input, f) for f in files
                           if f.endswith(".safetensors")]
            if not args.models:
                args.models = [os.path.join(args.input, f) for f in files
                               if f.endswith(".bin")]
    if not (args.config and args.tokenizer and args.models):
        ap.error("need --config, --tokenizer and --models (or an input dir)")

    with open(args.config) as f:
        config = json.load(f)
    convert(args.output, config, args.tokenizer, args.models, args.dtype,
            pad_vocab=args.pad_vocab)


if __name__ == "__main__":
    main()
