"""Generation engine: model assembly, decode loop, perplexity and chat
(the port of ``calm_tpu.engine``).

- one .calm container gives the config, weights, tokenizer and sampler,
  with the reference's bandwidth/params accounting (src/run.c:131-152,
  523-532; MoE models count the active experts' share of the FFN bytes,
  as ``calm_tpu/engine.py:125-128``; a parallel-norm (Cohere) container
  holds no ffn-norm, so none is counted) feeding the perf line
  (src/run.c:249-253);
- the prompt goes through batched ``prefill`` in chunks of
  ``PREFILL_CHUNK``; tokens past the window are stepped;
- greedy decode runs ``decode_loop`` chunks with the argmax on the
  device; ``temperature > 0`` samples min-p on the host with the
  reference's xorshift64* stream (the JAX package's
  ``reference_sampling=True`` path);
- perplexity with a running mean +- standard error (src/run.c:258-316),
  and chat with vocab-sniffed templates (src/run.c:318-419);
- fp8 KV is chosen for contexts above 4096 (src/run.c:536-540);
- ``batch`` sizes the cache's slot axis for the continuous-batching
  server (``calm_tpu/engine.py:130``); the single-stream methods use an
  Engine of one slot.

Runs on the GPU unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import numpy as np
import torch

from calm_tpu_torch import model as M
from calm_tpu_torch.config import ModelConfig
from calm_tpu_torch.container import TensorFile
from calm_tpu_torch.device import pick
from calm_tpu_torch.sampler import Sampler, softmax_prob
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
    # prefill activations are (T, D) f32 per layer and perplexity's logits
    # (T, V) f32: chunks bound both (the attention kernel itself is flat in T)
    PREFILL_CHUNK = 8192

    def __init__(self, path: str, context: int = 0,
                 kv_dtype: str | None = None, device=None, batch: int = 1):
        self.device = pick(device)
        self.tf = TensorFile(path)
        self.path = path
        self.cfg = ModelConfig.from_metadata(self.tf.metadata, context)
        M.check_supported(self.cfg, self.device)
        self.tokenizer = Tokenizer.from_container(self.tf)
        self._set_kv(kv_dtype, batch)

        self.weights = M.load_weights(self.tf, self.cfg, self.device)

        # weight bytes/params accounting (src/run.c:523-532)
        self.n_bytes, self.n_params = self.tf.count_bytes("model.")
        embed_bytes, _ = self.tf.count_bytes("model.embed.")
        self.n_bandwidth = self.n_bytes - embed_bytes
        if self.tf.find("model.output.weight") is None:
            self.n_bandwidth += self.tf.nbytes("model.embed.weight")
        if self.cfg.n_experts:  # a token reads only its active experts
            mlp_bytes, _ = self.tf.count_bytes("model.layers.", ".mlp.w")
            self.n_bandwidth -= mlp_bytes
            self.n_bandwidth += mlp_bytes // self.cfg.n_experts * self.cfg.n_experts_ac

        self.cache = M.KVCache.create(self.cfg, batch, self._kv_torch, self.device)

    @classmethod
    def from_weights(cls, cfg: ModelConfig, weights: M.Weights,
                     tokenizer: Tokenizer, *, n_bytes: int, n_params: int,
                     n_bandwidth: int, kv_dtype: str | None = None,
                     device=None, batch: int = 1) -> "Engine":
        """An Engine around weights already built on the device, with no
        container (a model made in memory, e.g. by ``utils.synth``); the
        byte counts feed the banner and the perf line."""
        self = cls.__new__(cls)
        self.device = pick(device)
        self.tf, self.path = None, "<memory>"
        self.cfg, self.weights, self.tokenizer = cfg, weights, tokenizer
        M.check_supported(cfg, self.device)
        self.n_bytes, self.n_params, self.n_bandwidth = n_bytes, n_params, n_bandwidth
        self._set_kv(kv_dtype, batch)
        self.cache = M.KVCache.create(cfg, batch, self._kv_torch, self.device)
        return self

    def _set_kv(self, kv_dtype: str | None, batch: int):
        if kv_dtype is None:
            kv_dtype = "fp8" if self.cfg.seq_len > 4096 else "bf16"
        self.kv_dtype = kv_dtype
        self._kv_torch = M.KV_DTYPES[kv_dtype]
        self.kv_bits = 8 if kv_dtype == "fp8" else 16
        self.batch = batch

    # -- info ---------------------------------------------------------------

    def banner(self) -> str:
        c = self.cfg
        kv_gib = kv_cache_bytes(c, self.kv_bits, c.seq_len - 1) / 2**30
        moe = f", {c.n_experts} experts ({c.n_experts_ac} active)" if c.n_experts else ""
        return (f"# {self.path}: {self.n_params / 1e9:.1f}B params "
                f"({self.n_bytes / 2**30:.1f} GiB @ {self.n_bytes * 8 / self.n_params:.2f} bpw), "
                f"{c.seq_len} context (kvcache {kv_gib:.1f} GiB @ {self.kv_dtype}){moe}")

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

    def _prefill(self, tokens: list[int], pos0: int, logits_mode: str):
        return M.prefill(self.cfg, self.weights,
                         torch.tensor([tokens], dtype=torch.int64, device=self.device),
                         [pos0], self.cache, logits_mode)[0]

    def prefill_tokens(self, tokens: list[int], pos0: int = 0) -> np.ndarray:
        """Feed prompt tokens in batched chunks (``calm_tpu/engine.py``
        :151-170); tokens past the window are stepped. Returns the logits
        after the last one."""
        seq_len = self.cfg.seq_len
        logits = None
        i = 0
        while i < len(tokens):
            if pos0 + i >= seq_len:  # rolling decode steps
                logits = self.step(tokens[i], pos0 + i)
                i += 1
                continue
            n = min(self.PREFILL_CHUNK, seq_len - (pos0 + i))
            chunk = tokens[i:i + n]
            logits = self._prefill(chunk, pos0 + i, "last")[0].float().cpu().numpy()
            i += len(chunk)
        return logits

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

    def perplexity(self, text: str, steps: int = 0,
                   progress: Callable[[str], None] | None = None):
        """Chunked perplexity with running mean +- SE (src/run.c:258-316,
        ``calm_tpu/engine.py:299-335``): each window of ``steps`` tokens
        (the context when 0) is teacher-forced from position 0, in
        prefill chunks of at most ``PREFILL_CHUNK`` rows of logits."""
        toks = self.tokenizer.encode(text, bos=True)
        n = len(toks)
        window = steps if steps > 0 else self.cfg.seq_len
        s = ss = den = 0.0
        ppl = pplerr = 0.0
        i = 0
        while i + 1 < n:
            t = min(window, n - i)  # toks[i:i+t] at positions 0..t-1
            self.reset()
            for j0 in range(0, t, self.PREFILL_CHUNK):
                j1 = min(t, j0 + self.PREFILL_CHUNK)
                logits = self._prefill(toks[i + j0:i + j1], j0, "all")
                logits = logits[0].float().cpu().numpy()  # (j1 - j0, V)
                # logits[j] predicts toks[i+j0+j+1] (the last one crosses
                # the window boundary, as the serial reference loop does)
                for j in range(j1 - j0):
                    if i + j0 + j + 1 >= n:
                        break
                    lp = math.log(max(softmax_prob(toks[i + j0 + j + 1], logits[j]),
                                      1e-45))
                    s += lp
                    ss += lp * lp
                    den += 1
                    ppl = math.exp(-s / den)
                    pplerr = ppl * math.sqrt(max(ss - s * s / den, 0.0) / den / den)
            if progress:
                progress(f"# progress ({int(den)}/{n - 1}): {ppl:.3f} ± {pplerr:.3f}")
            i += t
        return ppl, pplerr, int(den)


# -- chat templates (vocab-sniffed, reference: src/run.c:318-347) -------------

_TEMPLATES = [
    ("<|eot_id|>",  # llama3
     "<|start_header_id|>system<|end_header_id|>\n\n{sys}<|eot_id|>"
     "<|start_header_id|>user<|end_header_id|>\n\n{user}<|eot_id|>"
     "<|start_header_id|>assistant<|end_header_id|>\n\n",
     "<|start_header_id|>user<|end_header_id|>\n\n{user}<|eot_id|>"
     "<|start_header_id|>assistant<|end_header_id|>\n\n"),
    ("<|im_start|>",  # chatml
     "<|im_start|>system\n{sys}<|im_end|>\n<|im_start|>user\n{user}<|im_end|>\n"
     "<|im_start|>assistant\n",
     "\n<|im_start|>user\n{user}<|im_end|>\n<|im_start|>assistant\n"),
    ("<start_of_turn>",  # gemma
     "<start_of_turn>user\nSYSTEM: {sys}\n\n{user}<end_of_turn>\n<start_of_turn>model\n",
     "\n<start_of_turn>user\n{user}<end_of_turn>\n<start_of_turn>model\n"),
    ("<|START_OF_TURN_TOKEN|>",  # cohere
     "<|START_OF_TURN_TOKEN|><|SYSTEM_TOKEN|>{sys}<|END_OF_TURN_TOKEN|>"
     "<|START_OF_TURN_TOKEN|><|USER_TOKEN|>{user}<|END_OF_TURN_TOKEN|>"
     "<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>",
     "<|START_OF_TURN_TOKEN|><|USER_TOKEN|>{user}<|END_OF_TURN_TOKEN|>"
     "<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>"),
    ("<|assistant|>",  # phi3
     "<|system|>\n{sys}<|end|>\n<|user|>\n{user}<|end|>\n<|assistant|>\n",
     "\n<|user|>\n{user}<|end|>\n<|assistant|>\n"),
    ("<|beginofsystem|>",  # k2
     "<|beginofsystem|>{sys}<|endofsystemprompt|><|beginofuser|>{user}<|beginofsystem|>",
     "<|beginofuser|>{user}<|beginofsystem|>"),
]
_LLAMA2 = ("[INST] <<SYS>>\n{sys}\n<</SYS>>\n\n{user} [/INST]",
           "[INST] {user} [/INST]")


def chat_template(tokenizer: Tokenizer, has_system: bool) -> str:
    for marker, with_sys, without in _TEMPLATES:
        if tokenizer.find(marker) >= 0:
            return with_sys if has_system else without
    return _LLAMA2[0] if has_system else _LLAMA2[1]


def chat_loop(engine: Engine, system_prompt: str = "", cli_prompt: str | None = None,
              *, temperature: float = 1.0, minp: float = 0.1, seed: int = 42,
              read_line: Callable[[], str] = input,
              write: Callable[[str], None] = lambda s: print(s, end="", flush=True),
              max_turns: int | None = None, max_reply: int | None = None):
    """Interactive chat (src/run.c:349-419, ``calm_tpu/engine.py:378-441``)
    with injected IO. Each reply is sampled token by token on the host with
    the xorshift64* stream (the JAX package's ``reference_sampling=True``
    path) and ends at eos/eot, or after ``max_reply`` tokens when given.
    The session ends at EOF on ``read_line`` or after ``max_turns``."""
    tok = engine.tokenizer
    sampler = Sampler(engine.cfg.vocab_size, seed, temperature, minp)
    pos = 0
    turns = 0
    while max_turns is None or turns < max_turns:
        if pos == 0 and cli_prompt is not None:
            user = cli_prompt + "\n"
        else:
            write(f"[{pos}/{engine.cfg.seq_len}] User: ")
            try:
                user = read_line()
            except EOFError:
                return
        tpl = chat_template(tok, bool(system_prompt) and pos == 0)
        rendered = (tpl.format(sys=system_prompt, user=user.rstrip("\n"))
                    if "{sys}" in tpl else tpl.format(user=user.rstrip("\n")))
        prompt_tokens = tok.encode(rendered, bos=(pos == 0))

        write("\nAssistant: ")
        if len(prompt_tokens) > 1:
            engine.prefill_tokens(prompt_tokens[:-1], pos)
        pos += len(prompt_tokens) - 1
        token = prompt_tokens[-1]
        n = 0
        while True:
            nxt = sampler.sample(engine.step(token, pos))
            pos += 1
            n += 1
            if nxt in (tok.eos_id, tok.eot_id) or (max_reply is not None
                                                   and n >= max_reply):
                write("\n\n")
                break
            write(tok.decode_piece(token, nxt).decode("utf-8", errors="replace"))
            token = nxt
        turns += 1
