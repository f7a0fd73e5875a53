"""The port's converter (``calm_tpu_torch.tools.convert``) against
``tools/convert.py``: the same container, byte for byte (names, dtype
tags, shapes, data and metadata), for every checkpoint of
``test_torch_convert.py``'s ``CASES`` (its 13 cases: the architectures,
fp8e4 and ``--pad-vocab``, made by ``transformers`` from a seed) at each
of the four formats, for BF16 checkpoints written with torch alone
(``utils.modelgen.write_hf_checkpoint``: Llama and Mixtral, as downloads
hold them), a ``.bin`` input and ``--pad-vocab``. The converter runs on
the host: it needs no GPU."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from calm_tpu_torch.container import TensorFile
from calm_tpu_torch.tools import convert as TC
from calm_tpu_torch.utils.modelgen import write_hf_checkpoint

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import convert as JC  # noqa: E402
from tests.test_torch_convert import CASES  # noqa: E402

torch.set_num_threads(1)
ROOT = str(Path(__file__).resolve().parents[1])
DTYPES = ("fp16", "fp8", "fp8e4", "gf4")
LLAMA = {"architectures": ["LlamaForCausalLM"], "hidden_size": 64, "intermediate_size": 96,
         "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
         "vocab_size": 270, "max_position_embeddings": 128, "bos_token_id": 1,
         "eos_token_id": 2, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
         "hidden_act": "silu", "tie_word_embeddings": False}
MIXTRAL = dict(LLAMA, architectures=["MixtralForCausalLM"], num_local_experts=4,
               num_experts_per_tok=2)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Each case's checkpoint directory, written once: (dir, its extra
    converter flags with any ``--dtype`` left out)."""
    made = {}

    def get(name):
        if name not in made:
            d = tmp_path_factory.mktemp(name)
            _, args = CASES[name][0](d)
            keep = [a for i, a in enumerate(args)
                    if a != "--dtype" and (i == 0 or args[i - 1] != "--dtype")]
            made[name] = (d, keep)
        return made[name]
    return get


def same_container(a: str, b: str):
    """Both files hold the same tensors in the same order, with equal tags,
    shapes, bytes and metadata, and are equal byte for byte."""
    ta, tb = TensorFile(a), TensorFile(b)
    assert ta.names() == tb.names()
    assert ta.metadata == tb.metadata
    for k in ta.names():
        assert ta.find(k) == tb.find(k), k
        assert np.array_equal(ta.get(k).view(np.uint8), tb.get(k).view(np.uint8)), k
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def convert_both(tmp_path, argv_tail):
    a, b = str(tmp_path / "jax.calm"), str(tmp_path / "port.calm")
    JC.main([a] + argv_tail)
    TC.main([b] + argv_tail)
    same_container(a, b)
    return b


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_cases_convert_as_jax(tmp_path, checkpoints, name, dtype):
    d, args = checkpoints(name)
    out = convert_both(tmp_path, [str(d), "--dtype", dtype] + args)
    assert TensorFile(out).metadata["dtype"] == dtype


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("config", [LLAMA, MIXTRAL], ids=["llama", "mixtral"])
def test_bf16_checkpoint_converts_as_jax(tmp_path, config, dtype):
    """A BF16 checkpoint written with torch alone: the port widens its
    bf16 bits exactly, as ml_dtypes does for the JAX converter."""
    d = tmp_path / "hf"
    write_hf_checkpoint(str(d), config, seed=3, std=0.5)
    tags = {TensorFile(str(d / "model.safetensors")).find(k)[0]
            for k in TensorFile(str(d / "model.safetensors")).names()}
    assert tags == {"BF16"}
    convert_both(tmp_path, [str(d), "--dtype", dtype])


@pytest.mark.parametrize("dtype", ["fp8", "gf4"])
def test_bf16_pad_vocab_converts_as_jax(tmp_path, dtype):
    d = tmp_path / "hf"
    write_hf_checkpoint(str(d), LLAMA, seed=4)
    out = convert_both(tmp_path, [str(d), "--dtype", dtype, "--pad-vocab"])
    tf = TensorFile(out)
    assert tf.metadata["vocab_size"] == "384" and tf.find("model.output.weight")[1][0] == 384


@pytest.mark.parametrize("dtype", ["fp16", "fp8e4"])
def test_bin_input_converts_as_jax(tmp_path, dtype):
    """A ``.bin`` checkpoint (``torch.load``) with bf16 tensors."""
    d = tmp_path / "hf"
    write_hf_checkpoint(str(d), LLAMA, seed=5, std=0.3)
    tf = TensorFile(str(d / "model.safetensors"))
    state = {k: torch.from_numpy(np.array(tf.get(k))).view(torch.bfloat16) for k in tf.names()}
    os.remove(d / "model.safetensors")
    torch.save(state, d / "pytorch_model.bin")
    convert_both(tmp_path, [str(d), "--dtype", dtype])


def test_converter_runs_without_gpu(tmp_path):
    """``python -m calm_tpu_torch.tools.convert`` on the host, no
    ``CALM_CPU`` asked for: it needs no device."""
    d = tmp_path / "hf"
    write_hf_checkpoint(str(d), LLAMA, seed=6)
    out = str(tmp_path / "m.calm")
    env = dict(os.environ)
    env.pop("CALM_CPU", None)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-m", "calm_tpu_torch.tools.convert", out, str(d),
                        "--dtype", "gf4"], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1].strip() == "saving 23 tensors"
    JC.main([str(tmp_path / "j.calm"), str(d), "--dtype", "gf4"])
    same_container(str(tmp_path / "j.calm"), out)
