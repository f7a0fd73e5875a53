"""The PyTorch port stands alone: importing it pulls in neither JAX, the
JAX package, triton nor ml_dtypes, and its entry points refuse to run on
a machine without a GPU unless the CPU is asked for."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "calm_tpu_torch")
FORBIDDEN = ("jax", "calm_tpu", "triton", "ml_dtypes")
MODULES = ["calm_tpu_torch", "calm_tpu_torch.config", "calm_tpu_torch.container",
           "calm_tpu_torch.quant", "calm_tpu_torch.tokenizer",
           "calm_tpu_torch.sampler", "calm_tpu_torch.device",
           "calm_tpu_torch.ops.norms", "calm_tpu_torch.ops.rope",
           "calm_tpu_torch.ops.qmm", "calm_tpu_torch.ops.build",
           "calm_tpu_torch.ops.hopper_qmm", "calm_tpu_torch.ops.hopper_attn",
           "calm_tpu_torch.model", "calm_tpu_torch.engine",
           "calm_tpu_torch.cli", "calm_tpu_torch.utils.synth",
           "calm_tpu_torch.paged", "calm_tpu_torch.serve", "calm_tpu_torch.httpd",
           "calm_tpu_torch.ops.hopper_stream", "calm_tpu_torch.tools.dma_ceiling",
           "calm_tpu_torch.tools.gf4_bound"]


def test_import_leaves_jax_out():
    code = ("import importlib, sys\n"
            f"for mod in {MODULES!r}:\n"
            "    importlib.import_module(mod)\n"
            f"    bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "    if bad: sys.exit(f'{mod} imported {bad}')\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _py_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_ast_scan_finds_no_jax_import():
    hits = []
    for path in _py_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for n in names:
                if n.split(".")[0] in ("jax", "calm_tpu", "ml_dtypes"):
                    hits.append(f"{path}: {n}")
    assert not hits, hits
    assert len(_py_files()) > 10


def test_triton_only_inside_functions():
    # nothing in the package imports triton at module level
    for path in _py_files():
        tree = ast.parse(open(path).read(), path)
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                        else [node.module or ""])
                assert not any(m.startswith("triton") for m in mods), path


def test_engine_without_gpu_raises(tmp_path):
    from tests.modelgen import tiny_config, write_tiny_model
    from calm_tpu_torch.device import NoGPUError
    from calm_tpu_torch.engine import Engine

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    p = str(tmp_path / "m.calm")
    write_tiny_model(p, tiny_config(dtype="fp8"), seed=1)
    with pytest.raises(NoGPUError):
        Engine(p)
    assert Engine(p, device="cpu").cfg.dtype == "fp8"


def test_cli_without_gpu_exits(tmp_path):
    from tests.modelgen import tiny_config, write_tiny_model

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    p = str(tmp_path / "m.calm")
    write_tiny_model(p, tiny_config(dtype="fp16"), seed=1)
    env = dict(os.environ, CALM_CPU="0")
    r = subprocess.run([sys.executable, "-m", "calm_tpu_torch.cli", p, "-n", "2"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 1 and "no CUDA GPU" in r.stderr, r.stderr
