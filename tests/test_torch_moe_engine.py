"""The port's Engine and CLI on tiny MoE containers against
calm_tpu.engine on the CPU: greedy generation (fp8 and gf4), perplexity,
the bandwidth accounting of active experts, and the CLI's ``-x``."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from calm_tpu import engine as JE
from calm_tpu import model as JM
from calm_tpu_torch import engine as TE
from tests.modelgen import tiny_config, write_tiny_model
from tests.test_torch_moe import _moe_model

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def moe_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("moe-eng") / "moe.calm")
    write_tiny_model(path, tiny_config(dtype="fp8", moe=True, seq_len=32), seed=6)
    return path


@pytest.mark.parametrize("name", ["fp8", "gf4"])
def test_moe_engine_generate_matches_jax(tmp_path, monkeypatch, moe_path, name):
    """Greedy generation (batched prefill of the prompt, then decode) gives
    the JAX engine's ids and text."""
    path = moe_path if name == "fp8" else _moe_model(tmp_path, "gf4", seed=4)
    ids = []
    real = JM.decode_scan

    def scan(*a, **k):
        out = real(*a, **k)
        ids.append(np.asarray(out[0])[0].tolist())
        return out

    monkeypatch.setattr(JM, "decode_scan", scan)
    js = JE.Engine(path).generate("hello there", 40, temperature=0)
    ts = TE.Engine(path, device="cpu").generate("hello there", 40, temperature=0)
    assert ts.ids == [t for chunk in ids for t in chunk][:len(ts.ids)]
    assert ts.text == js.text and len(set(ts.ids)) > 3


def test_moe_perplexity_and_accounting_match_jax(moe_path):
    """Perplexity over windows of 16 tokens, and the bandwidth accounting
    that counts only the active experts' FFN bytes."""
    text = "the quick brown fox jumps over the lazy dog, again."
    je, te = JE.Engine(moe_path), TE.Engine(moe_path, device="cpu")
    want = je.perplexity(text, steps=16)
    got = te.perplexity(text, steps=16)
    assert got[2] == want[2]
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-4)
    assert (te.n_bandwidth, te.n_bytes, te.n_params) == (
        je.n_bandwidth, je.n_bytes, je.n_params)
    assert te.n_bandwidth < te.n_bytes - te.tf.count_bytes("model.layers.", ".mlp.w")[0] // 2
    assert te.banner() == je.banner() + ", 4 experts (2 active)"


def test_moe_cli_perplexity_on_cpu(moe_path):
    env = dict(os.environ, CALM_CPU="1")
    txt = os.path.join(os.path.dirname(moe_path), "ppl.txt")
    with open(txt, "w") as f:
        f.write("ABCDABCDABCDABCD")
    r = subprocess.run([sys.executable, "-m", "calm_tpu_torch.cli", moe_path,
                        "-x", txt, "-n", "8"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "4 experts (2 active)" in r.stdout
    assert re.search(r"^# perplexity: [\d.]+ ± [\d.]+ \(", r.stdout, re.M), r.stdout
