"""The quality tool on the port (``calm_tpu_torch.tools.quality``) and
the port's own copies of the test model writer and the numpy oracle
(``utils.modelgen``, ``utils.oracle``), against ``tests/modelgen.py``,
``tests/oracle.py`` and ``tools/quality.py``: containers byte-equal at
the same seed, the oracle's logits within 1e-6 of scale, the SNR lines
equal to the printed digit, and the drift table's argmax agreement 6/6
on the CPU's plain path."""

import contextlib
import importlib
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from calm_tpu import container as JCont
from calm_tpu_torch.container import TensorFile
from calm_tpu_torch.tools import quality as TQ
from calm_tpu_torch.utils import modelgen as TM
from calm_tpu_torch.utils import oracle as TO
from tests import modelgen as JM
from tests import oracle as JO

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GF4 = dict(dim=64, hidden_dim=64, head_dim=16, rotary_dim=16, vocab_size=272)
KINDS = {
    "fp16": dict(dtype="fp16"), "fp8": dict(dtype="fp8"), "fp8e4": dict(dtype="fp8e4"),
    "gf4": dict(dtype="gf4", **GF4),
    "moe-fp8": dict(dtype="fp8", moe=True), "moe-fp8e4": dict(dtype="fp8e4", moe=True),
    "moe-gf4": dict(dtype="gf4", moe=True, **GF4),
    "cohere-fp16": dict(dtype="fp16", norm_ln=True, norm_par=True),
    "gelu-clip-fp8": dict(dtype="fp8", act_gelu=True, qkv_clip=0.5),
}


@pytest.mark.parametrize("tied,bias", [(False, False), (True, True)])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_write_tiny_model_is_jax_bytes(tmp_path, kind, tied, bias):
    a, b = str(tmp_path / "jax.calm"), str(tmp_path / "port.calm")
    JM.write_tiny_model(a, JM.tiny_config(**KINDS[kind]), seed=5, tied=tied, bias=bias)
    TM.write_tiny_model(b, TM.tiny_config(**KINDS[kind]), seed=5, tied=tied, bias=bias)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_tiny_config_and_byte_vocab_are_jax():
    for kind, kw in KINDS.items():
        assert TM.tiny_config(**kw).to_metadata() == JM.tiny_config(**kw).to_metadata(), kind
    for v in (259, 268, 272):
        for x, y in zip(TM.byte_vocab(v), JM.byte_vocab(v)):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("kind", ["fp16", "moe-fp8", "gf4", "fp8e4", "moe-fp8e4", "moe-gf4",
                                  "cohere-fp16", "gelu-clip-fp8"])
def test_oracle_forward_is_jax(tmp_path, kind):
    """The port's Oracle on the port's container reader against
    tests/oracle.py on calm_tpu's, token by token across the window's
    wrap (seq_len 8: the sinks rotate), within 1e-6 of max |logit|."""
    path = str(tmp_path / "m.calm")
    kw = dict(KINDS[kind], seq_len=8)
    JM.write_tiny_model(path, JM.tiny_config(**kw), seed=7, bias=kind == "fp16")
    want_o = JO.Oracle(JCont.TensorFile(path), JM.tiny_config(**kw))
    got_o = TO.Oracle(TensorFile(path), TM.tiny_config(**kw))
    for pos, tok in enumerate([1, 5, 9, 200, 42, 7, 3, 11, 250, 6, 17]):
        want, got = want_o.forward(tok, pos), got_o.forward(tok, pos)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), (kind, pos)


def _jax_quality(monkeypatch):
    monkeypatch.setenv("CALM_NO_COMPILE_CACHE", "1")
    return importlib.import_module("tools.quality")


def test_snr_lines_are_jax(monkeypatch):
    jq = _jax_quality(monkeypatch)
    outs = []
    for fn in (jq.format_snr, TQ.format_snr):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert len(re.findall(r"SNR +[\d.]+ dB", outs[1])) == 4


def test_drift_table_agrees_on_cpu():
    """``python -m calm_tpu_torch.tools.quality`` under CALM_CPU=1: the
    four SNR lines, then each format's drift against the f32 oracle
    stated, below 0.5%, with argmax agreement 6/6."""
    env = dict(os.environ, CALM_CPU="1", OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-m", "calm_tpu_torch.tools.quality", "--dim", "128",
                        "--layers", "2"], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert "synthetic 2-layer dim-128 model" in r.stdout
    rows = re.findall(r"^ +(\w+): max rel logit drift +([\d.]+)%, argmax agreement (\d)/6",
                      r.stdout, re.M)
    assert [f for f, _, _ in rows] == list(TQ.FORMATS), r.stdout
    assert all(a == "6" and float(d) < 0.5 for _, d, a in rows), rows


def test_logit_drift_returns_the_table(capsys):
    out = TQ.logit_drift(128, 1, torch.device("cpu"))
    assert set(out) == set(TQ.FORMATS)
    assert all(agree == 6 and drift < 5e-3 for drift, agree in out.values()), out
    cfg = TQ.drift_config("gf4", 128, 1)
    assert (cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.hidden_dim) == (64, 2, 1, 256)
