"""Generation engine: model assembly and the decode loop (the port of
``calm_tpu.engine``'s generate path).

- one .calm container gives the config, weights, tokenizer and sampler,
  with the reference's bandwidth/params accounting (src/run.c:131-152,
  523-532) feeding the perf line (src/run.c:249-253);
- the prompt is fed through ``decode_step`` one token at a time, as the
  reference C engine does (batched prefill comes with the prefill slice);
- greedy decode runs ``decode_loop`` chunks with the argmax on the
  device; ``temperature > 0`` samples min-p on the host with the
  reference's xorshift64* stream;
- fp8 KV is chosen for contexts above 4096 (src/run.c:536-540).

Runs on the GPU unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from calm_tpu_torch import model as M
from calm_tpu_torch.config import ModelConfig
from calm_tpu_torch.container import TensorFile
from calm_tpu_torch.device import pick
from calm_tpu_torch.sampler import Sampler
from calm_tpu_torch.tokenizer import Tokenizer


@dataclasses.dataclass
class GenStats:
    tokens: int
    seconds: float
    read_bytes: int
    logits_hash: int
    text: str
    ids: list[int] = dataclasses.field(default_factory=list)

    @property
    def tok_s(self) -> float:
        return self.tokens / self.seconds if self.seconds else 0.0

    @property
    def gb_s(self) -> float:
        return self.read_bytes / 1e9 / self.seconds if self.seconds else 0.0

    def perf_line(self) -> str:
        ms = self.seconds * 1000 / max(self.tokens, 1)
        return (f"# {self.tokens} tokens: throughput: {self.tok_s:.2f} tok/s; "
                f"latency: {ms:.2f} ms/tok; bandwidth: {self.gb_s:.2f} GB/s; "
                f"total {self.seconds:.3f} sec; #{self.logits_hash:08x}")


def kv_cache_bytes(cfg: ModelConfig, kv_bits: int, pos: int) -> int:
    """KV bytes read for one token at a given position (src/run.c:161-165)."""
    kv_len = cfg.seq_len if pos >= cfg.seq_len else pos + 1
    return 2 * (kv_bits // 8) * cfg.n_layers * cfg.kv_dim * kv_len


class Engine:
    CHUNK = 16  # greedy tokens per decode_loop call between stop checks

    def __init__(self, path: str, context: int = 0,
                 kv_dtype: str | None = None, device=None):
        self.device = pick(device)
        self.tf = TensorFile(path)
        self.cfg = ModelConfig.from_metadata(self.tf.metadata, context)
        M.check_supported(self.cfg, self.device)
        self.tokenizer = Tokenizer.from_container(self.tf)

        if kv_dtype is None:
            kv_dtype = "fp8" if self.cfg.seq_len > 4096 else "bf16"
        self.kv_dtype = kv_dtype
        self._kv_torch = M.KV_DTYPES[kv_dtype]
        self.kv_bits = 8 if kv_dtype == "fp8" else 16

        self.weights = M.load_weights(self.tf, self.cfg, self.device)

        # weight bytes/params accounting (src/run.c:523-532)
        self.n_bytes, self.n_params = self.tf.count_bytes("model.")
        embed_bytes, _ = self.tf.count_bytes("model.embed.")
        self.n_bandwidth = self.n_bytes - embed_bytes
        if self.tf.find("model.output.weight") is None:
            self.n_bandwidth += self.tf.nbytes("model.embed.weight")

        self.cache = M.KVCache.create(self.cfg, 1, self._kv_torch, self.device)

    # -- info ---------------------------------------------------------------

    def banner(self) -> str:
        c = self.cfg
        kv_gib = kv_cache_bytes(c, self.kv_bits, c.seq_len - 1) / 2**30
        return (f"# {self.tf.path}: {self.n_params / 1e9:.1f}B params "
                f"({self.n_bytes / 2**30:.1f} GiB @ {self.n_bytes * 8 / self.n_params:.2f} bpw), "
                f"{c.seq_len} context (kvcache {kv_gib:.1f} GiB @ {self.kv_dtype})")

    def reset(self):
        self.cache.k.zero_()
        self.cache.v.zero_()

    # -- low-level steps ------------------------------------------------------

    def _token(self, token: int) -> torch.Tensor:
        return torch.tensor([token], dtype=torch.int64, device=self.device)

    def step(self, token: int, pos: int) -> np.ndarray:
        """One decode step; returns f32 logits on the host."""
        out, self.cache = M.decode_step(self.cfg, self.weights,
                                        self._token(token), pos, self.cache)
        return out[0].float().cpu().numpy()

    def prefill_tokens(self, tokens: list[int], pos0: int = 0) -> np.ndarray:
        """Feed prompt tokens one decode step at a time; returns the logits
        after the last one."""
        out = None
        for i, t in enumerate(tokens):
            out, self.cache = M.decode_step(self.cfg, self.weights,
                                            self._token(t), pos0 + i, self.cache)
        return None if out is None else out[0].float().cpu().numpy()

    # -- generate -------------------------------------------------------------

    def generate(self, prompt: str = "", steps: int = 256, *,
                 temperature: float = 1.0, minp: float = 0.1, seed: int = 42,
                 pos_offset: int = 0, echo: bool = False,
                 on_piece: Callable[[str], None] | None = None) -> GenStats:
        """Decode one sequence (src/run.c:167-256): prompt tokens forced,
        stop on bos/eos/eot, perf accounting per token."""
        tok = self.tokenizer
        cfg = self.cfg
        sampler = Sampler(cfg.vocab_size, seed, temperature, minp)
        prompt_tokens = tok.encode(prompt, bos=True)
        if not prompt_tokens:
            prompt_tokens = [tok.bos_id if tok.bos_id >= 0 else 0]

        out = bytearray()
        ids: list[int] = []

        def emit(piece: bytes):
            out.extend(piece)
            if on_piece:
                on_piece(piece.decode("utf-8", errors="replace"))

        if echo and prompt_tokens[0] != tok.bos_id:
            emit(tok.decode_piece(tok.bos_id, prompt_tokens[0]))

        read_bytes = 0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        start = time.perf_counter()

        n_prompt = len(prompt_tokens)
        pos = 0
        if n_prompt > 1:
            self.prefill_tokens(prompt_tokens[:-1], pos_offset)
            read_bytes += (n_prompt - 1) * self.n_bandwidth
            for p in range(n_prompt - 1):
                read_bytes += kv_cache_bytes(cfg, self.kv_bits, p + pos_offset)
                if echo and p + 1 < n_prompt:
                    emit(tok.decode_piece(prompt_tokens[p], prompt_tokens[p + 1]))
            pos = n_prompt - 1

        token = prompt_tokens[-1]
        logits_last = None
        stops = (tok.bos_id, tok.eos_id, tok.eot_id)
        greedy = temperature == 0.0 or minp >= 1.0

        stopped = False
        while not stopped and (pos < steps or steps < 0):
            if greedy:
                n = self.CHUNK if steps < 0 else max(1, min(self.CHUNK, steps - pos))
                toks_d, self.cache, logits_d = M.decode_loop(
                    cfg, self.weights, self._token(token), pos + pos_offset,
                    self.cache, n)
                chunk = toks_d[0].tolist()
            else:
                logits_d = None
                logits_last = self.step(token, pos + pos_offset)
                chunk = [sampler.sample(logits_last)]
            for i, nxt in enumerate(chunk):
                read_bytes += self.n_bandwidth
                read_bytes += kv_cache_bytes(cfg, self.kv_bits, pos + pos_offset)
                pos += 1
                ids.append(int(nxt))
                last_step = i
                if nxt in stops:
                    stopped = True
                    break
                emit(tok.decode_piece(token, nxt))
                token = nxt
            if logits_d is not None:
                # fingerprint at the exact position decoded last
                logits_last = logits_d[last_step, 0].float().cpu().numpy()

        seconds = time.perf_counter() - start
        h = M.logits_hash(logits_last) if logits_last is not None else 0
        return GenStats(tokens=pos, seconds=seconds, read_bytes=read_bytes,
                        logits_hash=h, text=out.decode("utf-8", errors="replace"),
                        ids=ids)
