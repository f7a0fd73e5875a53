"""The model the benchmark serves, made from ``--seed``: its sizes and its
weights.

Speed does not depend on the weights' values, and no checkpoint can be
fetched, so every quantized matrix is random fp8 e5m2 bytes (the idea of
the port's ``utils/synth.py``, frozen here): a random sign, both
mantissa bits random, and the exponent field drawn uniformly from 3 to
10 of 31, so 2^-12 <= |w| <= 1.75 * 2^-5 and every value is finite.
Their root mean square, ~0.018 at these magnitudes, is about that of the
usual 1/sqrt(4096) initialisation. Much smaller weights (the port's
``utils/synth.py`` keeps the exponent at most 7) give a network whose
greedy output barely depends on its input: a few tokens win every
position by wide margins, and a check of served tokens sees nothing.
Norm weights are f32, uniform in [0.8, 1.2).

Each tensor of each layer draws from a ``torch.Generator`` on the device
seeded from (seed, tensor name, layer) alone, so one layer can be made
again without the others: the program gets whole layer stacks
(:func:`stacks`), and the reference, once the program's state is freed,
makes one layer at a time (:func:`layer`). The same seed gives the same
bytes on the same device.

This module imports torch and nothing of the program.
"""

from __future__ import annotations

import dataclasses
import hashlib

import torch

EXP_LO = 3  # the exponent field is EXP_LO + (3 random bits)
BOS, EOS = 1, 2
BYTE0 = 3  # token id of byte 0 in the byte-level vocabulary


@dataclasses.dataclass(frozen=True)
class Dims:
    """A configuration file's shape, in the names the benchmark uses."""

    name: str
    dim: int
    hidden: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    seq_len: int
    rope_theta: float
    norm_eps: float
    experts: int = 0
    experts_per_token: int = 0
    format: str = "fp8"
    kv_dtype: str = "bf16"

    @property
    def q_dim(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim

    @classmethod
    def from_json(cls, d: dict) -> "Dims":
        """Read the Hugging Face keys of a configuration file."""
        if d.get("format", "fp8") != "fp8":
            raise ValueError(f"{d['name']}: the benchmark makes fp8 weights only")
        heads = int(d["num_attention_heads"])
        dim = int(d["hidden_size"])
        return cls(name=d["name"], dim=dim, hidden=int(d["intermediate_size"]),
                   layers=int(d["num_hidden_layers"]), heads=heads,
                   kv_heads=int(d["num_key_value_heads"]),
                   head_dim=int(d.get("head_dim") or dim // heads),
                   vocab=int(d["vocab_size"]), seq_len=int(d["max_position_embeddings"]),
                   rope_theta=float(d["rope_theta"]), norm_eps=float(d["rms_norm_eps"]),
                   experts=int(d.get("num_local_experts", 0)),
                   experts_per_token=int(d.get("num_experts_per_tok", 0)),
                   format=d.get("format", "fp8"), kv_dtype=d.get("kv_dtype", "bf16"))


def layer_shapes(d: Dims) -> dict[str, tuple[tuple[int, ...], str]]:
    """name -> (shape of one layer's tensor, "fp8" | "f32"), in the order
    they are made."""
    ex = (d.experts,) if d.experts else ()
    s = {"attn_norm": ((d.dim,), "f32"), "ffn_norm": ((d.dim,), "f32"),
         "wq": ((d.q_dim, d.dim), "fp8"), "wk": ((d.kv_dim, d.dim), "fp8"),
         "wv": ((d.kv_dim, d.dim), "fp8"), "wo": ((d.dim, d.q_dim), "fp8"),
         "w1": (ex + (d.hidden, d.dim), "fp8"), "w2": (ex + (d.dim, d.hidden), "fp8"),
         "w3": (ex + (d.hidden, d.dim), "fp8")}
    if d.experts:
        s["moegate"] = ((d.experts, d.dim), "fp8")
    return s


def global_shapes(d: Dims) -> dict[str, tuple[tuple[int, ...], str]]:
    return {"embed": ((d.vocab, d.dim), "fp8"), "output": ((d.vocab, d.dim), "fp8"),
            "final_norm": ((d.dim,), "f32")}


def tensor_seed(seed: int, name: str, layer: int = -1) -> int:
    h = hashlib.sha256(f"{seed}/{name}/{layer}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def _fill(out: torch.Tensor, kind: str, seed: int, name: str, layer: int,
          gen: torch.Generator) -> None:
    """Fill ``out`` (uint8 for fp8, f32) in place from (seed, name, layer)."""
    gen.manual_seed(tensor_seed(seed, name, layer))
    if kind == "fp8":
        out.random_(0, 256, generator=gen)
        exp = ((out >> 2) & 7) + EXP_LO
        out.bitwise_and_(0x83).bitwise_or_(exp << 2)
    else:
        out.uniform_(0.8, 1.2, generator=gen)


def _empty(shape, kind: str, device) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.uint8 if kind == "fp8" else torch.float32,
                       device=device)


def _typed(t: torch.Tensor, kind: str) -> torch.Tensor:
    return t.view(torch.float8_e5m2) if kind == "fp8" else t


def layer(d: Dims, seed: int, l: int, device) -> dict[str, torch.Tensor]:
    """Layer ``l``'s tensors, fp8 as float8_e5m2, bit for bit those of
    :func:`stacks`' row ``l``."""
    gen = torch.Generator(device=device)
    out = {}
    for name, (shape, kind) in layer_shapes(d).items():
        t = _empty(shape, kind, device)
        _fill(t, kind, seed, name, l, gen)
        out[name] = _typed(t, kind)
    return out


def globals_(d: Dims, seed: int, device) -> dict[str, torch.Tensor]:
    """The embedding, the lm-head and the final norm."""
    gen = torch.Generator(device=device)
    out = {}
    for name, (shape, kind) in global_shapes(d).items():
        t = _empty(shape, kind, device)
        _fill(t, kind, seed, name, -1, gen)
        out[name] = _typed(t, kind)
    return out


def stacks(d: Dims, seed: int, device) -> dict[str, torch.Tensor]:
    """Every layer tensor as an (L, ...) stack, plus :func:`globals_`: one
    fill a layer and tensor, each into its row of the stack."""
    gen = torch.Generator(device=device)
    out = {}
    for name, (shape, kind) in layer_shapes(d).items():
        t = _empty((d.layers,) + shape, kind, device)
        for l in range(d.layers):
            _fill(t[l], kind, seed, name, l, gen)
        out[name] = _typed(t, kind)
    out.update(globals_(d, seed, device))
    return out


def byte_pieces(vocab: int) -> list[bytes]:
    """A byte-level vocabulary: <unk>, BOS, EOS, the 256 byte pieces, then
    fillers no text encodes to. A text of n bytes is n tokens."""
    pieces = [b"<unk>", b"<s>", b"</s>"] + [f"<0x{b:02X}>".encode() for b in range(256)]
    pieces += [f"<fill{i}>".encode() for i in range(len(pieces), vocab)]
    return pieces


def encode(text: str) -> list[int]:
    """The benchmark's own tokenization of a prompt: BOS, then one token a
    byte."""
    return [BOS] + [BYTE0 + b for b in text.encode()]
