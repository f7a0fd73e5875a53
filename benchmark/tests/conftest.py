"""The benchmark's own tests: CPU only, at tiny sizes, except those marked
``card``, which need a CUDA card and skip without one. Run them with
``python3 -m pytest benchmark/tests -q`` from the repository's root."""

from __future__ import annotations

import json
import os
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(ROOT)

TINY = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, vocab_size=320, max_position_embeddings=256)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")
    import torch
    # tiny sizes: one thread, where several contend (index_add_ slows a
    # thousandfold) for nothing
    torch.set_num_threads(1)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _shrink(cell: dict) -> dict:
    """A cell's parameters at a size the CPU runs in seconds."""
    p = cell["params"]
    if cell["driver"] == "stream":
        p.update(prompt_bytes=64, new_tokens=24, prompts=4, warm_tokens=4)
    elif cell["driver"] == "open_loop":
        p.update(rate=60.0, slots=4, system_bytes=32, prefix_cache_tokens=512,
                 user_bytes=dict(median=16, sigma=1.0, lo=4, hi=64),
                 output_tokens=dict(median=8, sigma=0.8, lo=2, hi=32), warm_user_bytes=[4, 40])
    elif cell["driver"] == "closed_loop":
        p.update(slots=4, clients=4, pool=16, prompt_bytes=dict(median=32, sigma=0.8, lo=8, hi=96),
                 output_tokens=dict(median=16, sigma=0.8, lo=4, hi=64), warm_prompt_bytes=[8, 80])
    cell["check"]["requests"] = 8
    # the tiny model's logits spread ~0.2 (the full widths' ~1.2) and its
    # CPU path reads a gap of 0 against the reference; a broken path reads
    # a mean gap of 3e-3 or more
    cell["check"]["limits"] = {"max_logit_gap": 0.01, "mean_logit_gap": 1e-3}
    return cell


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark whose configurations are cut to a tiny
    width and whose cells are cut to CPU sizes (same names)."""
    root = tmp_path / "benchmark"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in (root / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c.update(TINY)
        f.write_text(json.dumps(c))
    for f in (root / "workloads").glob("*.json"):
        f.write_text(json.dumps(_shrink(json.loads(f.read_text()))))
    return str(root)


def plant(monkeypatch, fault: str) -> None:
    """Break the timed path underneath the harness: ``state_unchanged``, a
    decode step writes no K/V row; ``half_batch``, every other slot's
    logits are left out of the step (zeroed); ``token_altered``, each
    token is changed where it is chosen. Planted before set-up, so that a
    step captured on the card captures the fault."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch import sampler as S
    if fault == "state_unchanged":  # a decode step writes no K/V
        monkeypatch.setattr(M, "_write_rows", lambda *a, **k: None)
    elif fault == "half_batch":  # every other slot is left out of the step
        real = M.decode_once

        def half(cfg, w, token, pos, cache, *a, **k):
            out, nxt = real(cfg, w, token, pos, cache, *a, **k)
            out = out.clone()
            out[1::2] = 0
            return out, out.argmax(-1)
        monkeypatch.setattr(M, "decode_once", half)
    elif fault == "token_altered":
        real_loop, real_sample = M.decode_loop, S.Sampler.sample

        def loop(*a, **k):
            toks, cache, logits = real_loop(*a, **k)
            return (toks + 7) % logits.shape[-1], cache, logits
        monkeypatch.setattr(M, "decode_loop", loop)
        monkeypatch.setattr(S.Sampler, "sample", lambda self, lg: (real_sample(self, lg) + 7)
                            % len(lg))
