"""Whole runs of the harness on the CPU at tiny sizes: the reference
agrees with the port's CPU path, a new cell or metric is found by adding
files, a broken timed path is caught, no JAX module is loaded, and the
command itself never runs without a card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests.conftest import REPO, plant

CELLS = ("mistral7b.stream", "mixtral8x7b.stream", "mistral7b.chat", "mixtral8x7b.batch32")
SEED = 2**31 + 4242


def run(root, cell, trace=False, seconds=2.0, **kw):
    return run_cell(cell, SEED, seconds, trace, device="cpu", root=root, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_ports_cpu_path(tiny_root, cell):
    r = run(tiny_root, cell)
    c = r["compared"]
    assert r["correct"], c
    assert c["requests_checked"]["value"] >= 1 and c["prompt_ids_differing"]["value"] == 0
    # the CPU path is f32 with a bf16 cache: no flip past rounding
    assert c["max_logit_gap"]["value"] < 1e-3
    assert list(r)[-1] == "compared" and r["attempted"] >= 1 and r["failed"] == 0
    e2e = set(json.load(open(os.path.join(tiny_root, "workloads", f"{cell}.json")))["end_to_end"])
    assert set(r["metrics"]) == e2e and all(v["value"] > 0 for v in r["metrics"].values())


def test_reference_logits_match_the_ports_prefill(tiny_root):
    """Teacher-forced logits of the port's CPU prefill against the
    reference's, dense and MoE."""
    from benchmark import program
    from benchmark import weights as W
    from benchmark.reference.model import logits_at
    from calm_tpu_torch import model as M
    for cfg in ("mistral-7b-fp8", "mixtral-8x7b-fp8"):
        d = W.Dims.from_json(json.load(open(os.path.join(tiny_root, "configs", f"{cfg}.json"))))
        eng = program.engine(d, W.stacks(d, 77, "cpu"), "cpu")
        toks = W.encode("the quick brown fox jumps over the lazy dog" * 3)
        got = M.prefill(eng.cfg, eng.weights, torch.tensor([toks]), [0], eng.cache, "all")[0][0]
        ref = logits_at(d, 77, [toks], [list(range(len(toks)))], "cpu")[0]
        err = (got.float() - ref).abs().max() / ref.abs().max()
        assert err < 2e-2, (cfg, float(err))


def test_a_new_cell_and_metric_are_found_by_their_files(tiny_root):
    with open(os.path.join(tiny_root, "workloads", "mistral7b.chat.json")) as f:
        cell = json.load(f)
    cell.update(name="mistral7b.chat_copy", per_layer=["ticks_counted.itl"])
    with open(os.path.join(tiny_root, "workloads", "mistral7b.chat_copy.json"), "w") as f:
        json.dump(cell, f)
    with open(os.path.join(tiny_root, "metrics", "ticks_counted.itl.py"), "w") as f:
        f.write('UNIT = "ticks"\n\n\ndef read(r):\n    return float(len(r.ticks)) or None\n')
    r = run(tiny_root, "mistral7b.chat_copy", trace=True)
    assert r["metrics"]["ticks_counted.itl"]["unit"] == "ticks"
    assert r["metrics"]["ticks_counted.itl"]["value"] > 0


@pytest.mark.parametrize("cell,fault", [
    ("mistral7b.stream", "state_unchanged"), ("mistral7b.stream", "token_altered"),
    ("mixtral8x7b.stream", "token_altered"),
    ("mistral7b.chat", "state_unchanged"), ("mistral7b.chat", "half_batch"),
    ("mistral7b.chat", "token_altered"),
    ("mixtral8x7b.batch32", "half_batch"), ("mixtral8x7b.batch32", "token_altered")])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    plant(monkeypatch, fault)
    r = run(tiny_root, cell)
    assert not r["correct"], r["compared"]


def test_controls_read_wider_gaps(tiny_root):
    r = run(tiny_root, "mistral7b.chat", control=True)
    for k in ("max_logit_gap", "mean_logit_gap"):
        assert r["readings"][k] < r["controls"]["w4"][k]
    assert list(r)[-1] == "compared"


def test_no_jax_module_is_loaded(tiny_root):
    code = ("import sys, json; from benchmark.run import run_cell, forbidden_modules; "
            f"run_cell('mixtral8x7b.batch32', 5, 1.0, False, device='cpu', root={tiny_root!r}); "
            "print(json.dumps(forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=600, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_a_jax_module_loaded_by_a_metric_reader_gives_no_result(tiny_root, tmp_path):
    """A reader that loads a module named ``jax`` after the window has
    closed: the run ends without a result."""
    (tmp_path / "stub" / "jax").mkdir(parents=True)
    (tmp_path / "stub" / "jax" / "__init__.py").write_text("")
    with open(os.path.join(tiny_root, "workloads", "mistral7b.stream.json")) as f:
        cell = json.load(f)
    cell["per_layer"] = ["jax_loaded.decode"]
    with open(os.path.join(tiny_root, "workloads", "mistral7b.stream.json"), "w") as f:
        json.dump(cell, f)
    with open(os.path.join(tiny_root, "metrics", "jax_loaded.decode.py"), "w") as f:
        f.write('UNIT = "%"\n\n\ndef read(r):\n    import jax  # noqa: F401\n    return 1.0\n')
    code = ("import json; from benchmark.run import run_cell; "
            f"print(json.dumps(run_cell('mistral7b.stream', 5, 1.0, True, device='cpu', "
            f"root={tiny_root!r})))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path / "stub"), REPO]))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=600, env=env)
    assert out.returncode != 0 and out.stdout.strip() == "", out.stdout
    assert "['jax']" in out.stderr, out.stderr[-2000:]


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.compare, benchmark.weights, "
            "benchmark.roofline; print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'calm_tpu_torch', 'calm_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "mistral7b.stream",
                          "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "mistral7b.stream",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
