"""The acceptance gate on the port (``calm_tpu_torch.tools.accept``)
against ``tools/accept.py`` under ``CALM_CPU=1``: ``--selftest``
synthesizes the same checkpoints byte for byte, and ``--configs 1,2``
ends in PASS with JAX's gate rows (config, stage, verdict), each
perplexity within 1e-3 relative of JAX's engine's. Also: without
``transformers`` ``--selftest`` exits 2 and says why; the cross-check's
card rule (greedy ids of the CPU's CLI, equal but at a near-tie of the
card's logits) through a stand-in engine; and the sharded row's rank
body on two gloo ranks against the unsharded step."""

import importlib
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from calm_tpu_torch.engine import Engine
from calm_tpu_torch.tools import accept as TA
from calm_tpu_torch.utils.modelgen import tiny_config, write_tiny_model

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--configs", "1,2", "--ppl-chars", "600", "--hash-steps", "16"]
HF_FILES = ("model.safetensors", "config.json", "tokenizer.json")


@pytest.fixture(scope="module")
def gates(tmp_path_factory):
    """Both gates' --selftest on their own roots, under CALM_CPU=1: (port
    JSON, JAX JSON, port root, JAX root, port's exit code, JAX's)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CALM_CPU", "1")
    mp.setenv("CALM_NO_COMPILE_CACHE", "1")
    try:
        ja = importlib.import_module("tools.accept")
        rt, rj = tmp_path_factory.mktemp("port"), tmp_path_factory.mktemp("jax")
        jt, jj = str(rt / "gate.json"), str(rj / "gate.json")
        rc_t = TA.main(["--selftest", str(rt), "--json", jt] + ARGS)
        rc_j = ja.main(["--selftest", str(rj), "--json", jj] + ARGS)
    finally:
        mp.undo()
    with open(jt) as f, open(jj) as g:
        return json.load(f), json.load(g), rt, rj, rc_t, rc_j


def test_selftest_checkpoints_are_jax_s(gates):
    _, _, rt, rj, _, _ = gates
    names = sorted(os.listdir(rj))
    assert [n for n in names if os.path.isdir(rj / n)] == [
        "llama-3-8b", "mistral-7b", "mixtral-8x7b", "tinyllama-1.1b", "yi-1.5-34b"]
    for n in names:
        if not os.path.isdir(rj / n):
            continue
        for f in HF_FILES:
            with open(rt / n / f, "rb") as a, open(rj / n / f, "rb") as b:
                assert a.read() == b.read(), (n, f)


def test_gate_passes_with_jax_s_rows(gates):
    t, j, _, _, rc_t, rc_j = gates
    assert rc_t == rc_j == 0
    assert t["verdict"] == j["verdict"] == "PASS"
    assert [(r["config"], r["stage"], r["ok"]) for r in t["rows"]] == \
        [(r["config"], r["stage"], r["ok"]) for r in j["rows"]]
    assert [r["stage"] for r in t["rows"] if r["config"] == 1] == [
        "convert[fp16]", "hash[fp16]", "cpu-crosscheck", "ppl[fp16]", "bench[fp16]"]
    assert (t["backend"], t["device"], t["mode"]) == ("cpu", "cpu", "selftest")
    assert set(t) == set(j)


def test_perplexities_are_jax_engine_s(gates):
    t, j, _, _, _, _ = gates
    assert set(t["ppl"]) == set(j["ppl"]) == {"cfg1.fp16", "cfg2.fp16", "cfg2.fp8"}
    for k, p in t["ppl"].items():
        q = j["ppl"][k]
        assert p["tokens"] == q["tokens"] > 0
        assert abs(p["ppl"] - q["ppl"]) <= 1e-3 * q["ppl"], (k, p, q)
    for k, d in t["delta_vs_anchor"].items():
        assert abs(d - j["delta_vs_anchor"][k]) <= 2e-3, k


def test_selftest_without_transformers_exits_2(tmp_path):
    code = ("import sys\n"
            "sys.modules['transformers'] = None\n"
            "from calm_tpu_torch.tools import accept\n"
            f"sys.exit(accept.main(['--selftest', {str(tmp_path)!r}]))\n")
    env = dict(os.environ, CALM_CPU="1")
    env.pop("PYTHONPATH", None)
    for flag in ("--selftest", "--trained"):
        r = subprocess.run([sys.executable, "-c", code.replace("'--selftest'", repr(flag))],
                           cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        assert r.returncode == 2, r.stderr
        assert f"--{flag[2:]} builds its checkpoints with `transformers`" in r.stderr
        assert not os.listdir(tmp_path)


@pytest.fixture(scope="module")
def fp16_model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("m") / "m.calm")
    write_tiny_model(path, tiny_config(dtype="fp16", seq_len=64), seed=3)
    return path


class _Card:
    """A CPU engine that says it is on the card: the gate takes the card's
    cross-check rule for it."""

    def __init__(self, eng):
        self._eng = eng
        self.device = types.SimpleNamespace(type="cuda")

    def __getattr__(self, name):
        return getattr(self._eng, name)


@pytest.mark.parametrize("part", [None, 3])
def test_crosscheck_card_rule(fp16_model, part):
    """The CLI's ids on the CPU against the run's: equal ids pass; a run
    whose ids part from the CLI's at ``part`` passes only if the card's
    top-2 margin there is below 1e-3 of scale (``near_tie_margin`` on
    the engine's own ids)."""
    eng = Engine(fp16_model, device="cpu")
    a = eng.generate("The ", steps=12, temperature=0.0)
    if part is not None:
        a.ids = a.ids[:part] + [(a.ids[part] + 1) % eng.cfg.vocab_size] + a.ids[part + 1:]
    gate = TA.Gate()
    TA.cpu_crosscheck(_Card(eng), fp16_model, a, gate, 1,
                      types.SimpleNamespace(hash_steps=12))
    (cfg_id, stage, ok, detail), = gate.rows
    assert (cfg_id, stage) == (1, "cpu-crosscheck")
    if part is None:
        assert ok and "greedy ids equal (" in detail, detail
        return
    m = TA.near_tie_margin(eng, "The ", a.ids, part)
    assert m > 0 and ok == (m < TA.NEAR_TIE), detail
    assert f"equal up to {part}, then the card's top-2 margin {m:.2e}" in detail


def test_cli_prints_generated_ids(fp16_model):
    env = dict(os.environ, CALM_CPU="1", CALM_TOKENS="1")
    r = subprocess.run([sys.executable, "-m", "calm_tpu_torch.cli", fp16_model, "-t", "0",
                        "-n", "10", "-i", "The "], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    eng = Engine(fp16_model, device="cpu")
    assert TA._cli_ids(r.stdout) == eng.generate("The ", steps=10, temperature=0.0).ids


def test_sharded_row_rank_body_on_gloo(fp16_model):
    """tp=2 over two gloo ranks on the CPU: every rank's greedy id of
    token 1 at position 0 equals the unsharded engine's."""
    eng = Engine(fp16_model, device="cpu")
    want = int(np.argmax(eng.step(1, 0)))
    assert TA.tp_greedy(fp16_model, None, device="cpu") == [want, want]


def test_checkpoint_root_mode_finds_dirs(tmp_path, gates):
    _, _, rt, _, _, _ = gates
    root = tmp_path / "root"
    shutil.copytree(rt / "mistral-7b", root / "Mistral-7B-v0.1",
                    ignore=shutil.ignore_patterns("*.calm"))
    assert TA.find_ckpt_dir(str(root), ("mistral", "7b")) == str(root / "Mistral-7B-v0.1")
    assert TA.find_ckpt_dir(str(root), ("yi", "34b")) is None
