"""Model hyperparameter schema.

The .calm container is self-describing: all hyperparameters ride in the
safetensors metadata dict (string-valued). The key schema mirrors the
reference converter/runner contract (reference: tools/convert.py:55-125 writes
the keys, src/run.c:32-69 reads them) so containers are interchangeable.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Parameterized decoder-only transformer (reference: src/model.h:12-30)."""

    dim: int                     # transformer dimension
    hidden_dim: int              # ffn hidden dimension
    head_dim: int                # attention head dimension
    n_layers: int
    n_heads: int                 # query heads
    n_kv_heads: int              # kv heads (GQA/MQA when < n_heads)
    vocab_size: int
    seq_len: int                 # max sequence length (KV window)
    rope_theta: float = 10000.0
    rotary_dim: int = 0          # elements past rotary_dim are not rotated
    n_experts: int = 0           # MoE expert count (0 = dense)
    n_experts_ac: int = 0        # active experts per token
    norm_eps: float = 1e-5
    act_gelu: bool = False       # GELU (GEGLU) instead of SiLU (SwiGLU)
    norm_ln: bool = True         # mean-subtracting LayerNorm instead of RMSNorm
    norm_par: bool = False       # parallel attn+ffn off one norm (Cohere)
    norm_qk: bool = False        # RMSNorm on full q/k projections (OLMoE);
                                 # the reference converter warns and SKIPS this
                                 # (reference tools/convert.py:315) — we keep
                                 # exact parity with the HF forward instead
    moe_renorm: bool = True      # renormalize gate weights over the top-k
                                 # (Mixtral/DBRX; reference src/infer.c:277-305)
                                 # vs softmax-over-all probabilities (OLMoE)
    qkv_clip: float = math.inf   # clip qkv activations to [-clip, clip]

    # container-level fields (not part of the reference Config struct but
    # carried in the same metadata dict)
    arch: str = "llama"
    dtype: str = "fp16"          # weight container dtype: fp16 | fp8 | gf4
    bos_token_id: int = -1
    eos_token_id: int = -1

    @property
    def q_dim(self) -> int:
        return self.head_dim * self.n_heads

    @property
    def kv_dim(self) -> int:
        return self.head_dim * self.n_kv_heads

    @property
    def kv_mul(self) -> int:
        return self.n_heads // self.n_kv_heads

    @classmethod
    def from_metadata(cls, md: dict, context: int = 0) -> "ModelConfig":
        """Build a config from container metadata.

        Mirrors the reference runner's rules (src/run.c:32-69): seq_len is
        clamped to 4096 unless the model declares less, and an explicit
        ``context`` overrides it entirely.
        """
        head_dim = int(md["head_dim"]) if "head_dim" in md else int(md["dim"]) // int(md["n_heads"])

        max_seq_len = int(md.get("max_seq_len", 0))
        seq_len = max_seq_len if 0 < max_seq_len < 4096 else 4096
        if context:
            seq_len = context

        norm_type = md.get("norm_type", "")
        qkv_clip = float(md["qkv_clip"]) if "qkv_clip" in md else math.inf

        return cls(
            dim=int(md["dim"]),
            hidden_dim=int(md["hidden_dim"]),
            head_dim=head_dim,
            n_layers=int(md["n_layers"]),
            n_heads=int(md["n_heads"]),
            n_kv_heads=int(md["n_kv_heads"]),
            vocab_size=int(md["vocab_size"]),
            seq_len=seq_len,
            rope_theta=float(md.get("rope_theta", 10000.0)),
            rotary_dim=int(md.get("rotary_dim", head_dim)),
            n_experts=int(md.get("n_experts", 0)),
            n_experts_ac=int(md.get("n_experts_active", 0)),
            norm_eps=float(md.get("norm_eps", 1e-5)),
            act_gelu=md.get("act_type", "silu") == "gelu",
            norm_ln=norm_type.startswith("layernorm"),
            norm_par=norm_type == "layernorm_par",
            norm_qk=md.get("norm_qk", "0") == "1",
            moe_renorm=md.get("moe_renorm", "1") != "0",
            qkv_clip=qkv_clip,
            arch=md.get("arch", "llama"),
            dtype=md.get("dtype", "fp16"),
            bos_token_id=int(md.get("bos_token_id", -1)),
            eos_token_id=int(md.get("eos_token_id", -1)),
        )

    def to_metadata(self) -> dict:
        """Emit the string-valued metadata dict for the container writer."""
        md = {
            "arch": self.arch,
            "dtype": self.dtype,
            "dim": self.dim,
            "hidden_dim": self.hidden_dim,
            "head_dim": self.head_dim,
            "n_layers": self.n_layers,
            "n_heads": self.n_heads,
            "n_kv_heads": self.n_kv_heads,
            "vocab_size": self.vocab_size,
            "max_seq_len": self.seq_len,
            "bos_token_id": self.bos_token_id,
            "eos_token_id": self.eos_token_id,
            "rope_theta": self.rope_theta,
            "rotary_dim": self.rotary_dim,
            "norm_eps": self.norm_eps,
            "norm_type": ("layernorm_par" if self.norm_par
                          else "layernorm" if self.norm_ln else "rmsnorm"),
            "act_type": "gelu" if self.act_gelu else "silu",
        }
        if self.n_experts:
            md["n_experts"] = self.n_experts
            md["n_experts_active"] = self.n_experts_ac
        if self.qkv_clip != math.inf:
            md["qkv_clip"] = self.qkv_clip
        if self.norm_qk:
            md["norm_qk"] = 1
        if not self.moe_renorm:
            md["moe_renorm"] = 0
        return {k: str(v) for k, v in md.items()}
