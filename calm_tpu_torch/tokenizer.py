"""Byte-level BPE tokenizer driven by vocab/score tensors stored in the model
container.

Functional contract mirrors the reference tokenizer (src/tokenizer.c):

- vocab pieces are raw byte strings, NUL-separated in ``tokenizer.tokens``;
  merge priority rides in ``tokenizer.scores`` (higher score merges first —
  sentencepiece scores, or negative merge ranks from HF tokenizer.json)
- encoding: optional BOS, ``<|...|>`` special-token scanning, UTF-8 codepoint
  grouping with per-byte fallback (``<0x00>``..``<0xFF>`` pieces), then greedy
  highest-score pair merging via a max-heap (src/tokenizer.c:90-201)
- decoding: piece lookup with byte-fallback expansion and the
  sentencepiece-compatible "strip one leading space after BOS" rule
  (src/tokenizer.c:77-88)

Pure-Python copy of ``calm_tpu.tokenizer`` without the native encoder.
"""

from __future__ import annotations

import heapq

import numpy as np

MAX_TOKEN_LENGTH = 512


def tokenizer_bound(nbytes: int) -> int:
    """Upper bound of token count for a text of nbytes bytes (+BOS/EOS slack)."""
    return nbytes + 3


class Tokenizer:
    def __init__(self, pieces: list[bytes], scores: np.ndarray,
                 bos_id: int, eos_id: int):
        assert len(pieces) == len(scores)
        self.pieces = pieces
        self.scores = np.asarray(scores, dtype=np.float32)
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.vocab_size = len(pieces)

        self._lookup: dict[bytes, int] = {}
        for i, p in enumerate(pieces):
            if p and p not in self._lookup:
                self._lookup[p] = i

        self.byte_fallbacks = self._lookup.get(b"<0x00>", -1)

        self.eot_id = -1
        for marker in (b"<|eot_id|>", b"<|end|>", b"<|im_end|>"):
            tid = self._lookup.get(marker, -1)
            if tid >= 0:
                self.eot_id = tid
                break

    # -- construction -------------------------------------------------------

    @classmethod
    def from_tensors(cls, tokens_u8: np.ndarray, scores: np.ndarray,
                     bos_id: int, eos_id: int, vocab_size: int) -> "Tokenizer":
        """Build from container tensors (reference: src/run.c:119-129)."""
        blob = bytes(tokens_u8)
        if not blob.endswith(b"\0"):
            raise ValueError("tokenizer.tokens must be NUL-terminated")
        pieces = blob.split(b"\0")[:-1]
        if len(pieces) != vocab_size:
            raise ValueError(
                f"tokenizer.tokens holds {len(pieces)} pieces, expected {vocab_size}")
        for p in pieces:
            if len(p) > MAX_TOKEN_LENGTH:
                raise ValueError("token piece too long")
        return cls(pieces, np.asarray(scores, dtype=np.float32)[:vocab_size],
                   bos_id, eos_id)

    @classmethod
    def from_container(cls, tf) -> "Tokenizer":
        toks = tf.get("tokenizer.tokens", tag="U8")
        vocab_size = int(tf.metadata["vocab_size"])
        scores = tf.get("tokenizer.scores", tag="F32", shape=(vocab_size,))
        bos_id = int(tf.metadata["bos_token_id"])
        eos_id = int(tf.metadata["eos_token_id"])
        return cls.from_tensors(toks, scores, bos_id, eos_id, vocab_size)

    # -- api ----------------------------------------------------------------

    def find(self, piece: bytes | str) -> int:
        if isinstance(piece, str):
            piece = piece.encode("utf-8")
        return self._lookup.get(piece, -1)

    def encode(self, text: str | bytes, bos: bool = False, eos: bool = False) -> list[int]:
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        tokens: list[int] = []
        if bos and self.bos_id >= 0:
            tokens.append(self.bos_id)

        i, n = 0, len(data)
        while i < n:
            # special token scanning: <| ... |> encoded atomically if in vocab
            if data[i] == 0x3C and i + 1 < n and data[i + 1] == 0x7C:  # b"<|"
                end = data.find(b"|>", i + 2)
                if end != -1 and end + 2 - i <= MAX_TOKEN_LENGTH:
                    sid = self._lookup.get(data[i : end + 2], -1)
                    if sid != -1:
                        tokens.append(sid)
                        i = end + 2
                        continue

            # group a UTF-8 codepoint (lead byte 11xxxxxx + continuations)
            j = i + 1
            if data[i] & 0xC0 == 0xC0:
                while j < n and j - i < 4 and data[j] & 0xC0 == 0x80:
                    j += 1
            cp = data[i:j]
            i = j

            tid = self._lookup.get(cp, -1)
            if tid != -1:
                tokens.append(tid)
            elif self.byte_fallbacks >= 0:
                tokens.extend(b + self.byte_fallbacks for b in cp)
            # else: unknown codepoint is dropped (reference behavior)

        tokens = self._merge(tokens)

        if eos and self.eos_id >= 0:
            tokens.append(self.eos_id)
        return tokens

    def _merge(self, tokens: list[int]) -> list[int]:
        """Greedy highest-score pair merging via a max-heap.

        Entries carry (lpos, lid, rpos, rid); a popped entry is applied only
        if both positions still hold the recorded ids (stale entries are
        skipped), identical to src/tokenizer.c:151-201.
        """
        if len(tokens) < 2:
            return tokens
        toks = list(tokens)
        heap: list[tuple[float, int, int, int, int, int]] = []

        def tryadd(lpos: int, lid: int, rpos: int, rid: int):
            merged = self.pieces[lid] + self.pieces[rid]
            tid = self._lookup.get(merged, -1)
            if tid != -1:
                # min-heap on -score; lpos tiebreak for determinism
                heapq.heappush(heap, (-float(self.scores[tid]), lpos, lid, rpos, rid, tid))

        for k in range(len(toks) - 1):
            tryadd(k, toks[k], k + 1, toks[k + 1])

        while heap:
            _, lpos, lid, rpos, rid, resid = heapq.heappop(heap)
            if toks[lpos] != lid or toks[rpos] != rid:
                continue  # stale
            toks[lpos] = resid
            toks[rpos] = -1

            for k in range(lpos - 1, -1, -1):
                if toks[k] != -1:
                    tryadd(k, toks[k], lpos, resid)
                    break
            for k in range(rpos + 1, len(toks)):
                if toks[k] != -1:
                    tryadd(lpos, resid, k, toks[k])
                    break

        return [t for t in toks if t != -1]

    def decode_piece(self, prev_token: int, token: int) -> bytes:
        piece = self.pieces[token]
        if prev_token == self.bos_id and piece.startswith(b" "):
            piece = piece[1:]
        if self.byte_fallbacks >= 0 and 0 <= token - self.byte_fallbacks < 256:
            piece = bytes([token - self.byte_fallbacks])
        return piece

    def decode(self, tokens: list[int], first_prev: int | None = None) -> str:
        prev = self.bos_id if first_prev is None else first_prev
        out = bytearray()
        for t in tokens:
            out += self.decode_piece(prev, t)
            prev = t
        return out.decode("utf-8", errors="replace")
