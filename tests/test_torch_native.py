"""The port's native host library (``calm_tpu_torch.native`` over
native/*.cc, built with g++ into ``calm_tpu_torch/_build/``) against the
port's Python paths and the JAX package's: the cases of
tests/test_native.py (container parity and corruption, bad offsets,
tokenizer parity basic/random/real vocab, the rng, min-p, argmax), and the
library it loads is its own build, never ``calm_tpu/_native``."""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from calm_tpu import container as jcontainer
from calm_tpu.sampler import Sampler as JSampler
from calm_tpu.sampler import XorshiftRng as JRng
from calm_tpu.tokenizer import Tokenizer as JTokenizer
from calm_tpu_torch import container, native
from calm_tpu_torch.ops import build
from calm_tpu_torch.sampler import Sampler, XorshiftRng
from calm_tpu_torch.tokenizer import Tokenizer
from tests.modelgen import tiny_config, write_tiny_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("native") / "m.calm")
    write_tiny_model(path, tiny_config(dtype="fp8", vocab_size=272), seed=3)
    return path


def test_library_builds_into_the_port():
    """g++ builds native/*.cc under the port's build directory, named by
    the sources' hash."""
    assert native.available(), native.last_error()
    path = native.library_path()
    assert os.path.dirname(path) == build.BUILD_DIR
    assert path == build.host_target() and os.path.exists(path)
    assert "calm_tpu/_native" not in path


def test_never_loads_the_jax_packages_library(model_path):
    """A fresh process that tokenizes through the port maps the port's
    build and nothing of calm_tpu/_native, even with CALM_TPU_NATIVE
    pointing there (the JAX package's override)."""
    code = ("import sys\n"
            "from calm_tpu_torch.container import TensorFile\n"
            "from calm_tpu_torch.tokenizer import Tokenizer\n"
            f"t = Tokenizer.from_container(TensorFile({model_path!r}))\n"
            "assert t._native is not None and t.encode('hello', bos=True)\n"
            "maps = open('/proc/self/maps').read()\n"
            "print('port' if 'calm_tpu_torch/_build/libcalm_native' in maps else 'none',\n"
            "      'jax' if 'calm_tpu/_native' in maps else 'clean')\n")
    env = dict(os.environ, CALM_TPU_NATIVE=os.path.join(ROOT, "calm_tpu", "_native",
                                                        "libcalm_native.so"))
    env.pop("CALM_TPU_NO_NATIVE", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["port", "clean"]


# ---- container parser ----


def test_container_parity(model_path):
    py = container.TensorFile(model_path)
    jpy = jcontainer.TensorFile(model_path)
    nat = native.NativeContainer(model_path)
    assert sorted(nat.names()) == sorted(py.names()) == sorted(jpy.names())
    assert nat.metadata() == py.metadata == jpy.metadata
    for name in py.names():
        arr = py.get(name)
        tag, shape, nbytes = nat.info(name)
        assert shape == arr.shape and nbytes == arr.nbytes
        assert container.DTYPES[tag] == arr.dtype
    with pytest.raises(KeyError):
        nat.info("no.such.tensor")
    nat.close()


def test_container_rejects_corruption(model_path):
    blob = bytearray(open(model_path, "rb").read())
    assert native.parse_bytes(bytes(blob))
    cases = [
        blob[:4],                                   # truncated size
        b"\xff" * 8 + blob[8:],                     # absurd header size
        blob[:8] + b"not json" + blob[16:],         # broken JSON
    ]
    for bad in cases:
        assert not native.parse_bytes(bytes(bad))
        with tempfile.NamedTemporaryFile(suffix=".calm") as f:
            f.write(bad)
            f.flush()
            for reader in (container.TensorFile, jcontainer.TensorFile):
                with pytest.raises(Exception):
                    reader(f.name)


def test_container_rejects_bad_offsets():
    # a tensor past the data section
    hdr = b'{"t":{"dtype":"F32","shape":[4],"data_offsets":[0,16]}}'
    assert not native.parse_bytes(len(hdr).to_bytes(8, "little") + hdr + b"\x00" * 8)
    # a size that disagrees with the shape
    hdr = b'{"t":{"dtype":"F32","shape":[5],"data_offsets":[0,16]}}'
    assert not native.parse_bytes(len(hdr).to_bytes(8, "little") + hdr + b"\x00" * 16)
    assert native.last_error()  # the reader says why


# ---- tokenizer ----


def _vocab():
    pieces = [b"<unk>", b"<s>", b"</s>", b"<|im_end|>", b"<|im_start|>"]
    pieces += [bytes([b]) for b in range(97, 123)]  # a-z singles
    pieces += [b"he", b"ll", b"llo", b"hello", b" ", b" he", b"th", b"the",
               b"\xe4\xbd\xa0", b"\xe5\xa5\xbd", b"\xe4\xbd\xa0\xe5\xa5\xbd"]
    pieces += [f"<0x{b:02X}>".encode() for b in range(256)]
    scores = np.array([len(p) + 0.01 * i for i, p in enumerate(pieces)], np.float32)
    return pieces, scores


def _python_tokenizers(pieces, scores):
    """The port's and the JAX package's Python encoders."""
    os.environ["CALM_TPU_NO_NATIVE"] = "1"
    try:
        py = Tokenizer(pieces, scores, bos_id=1, eos_id=2)
        jpy = JTokenizer(pieces, scores, bos_id=1, eos_id=2)
    finally:
        del os.environ["CALM_TPU_NO_NATIVE"]
    assert py._native is None and jpy._native is None
    return py, jpy


def test_tokenizer_parity_basic():
    pieces, scores = _vocab()
    py, jpy = _python_tokenizers(pieces, scores)
    nat = native.NativeTokenizer(pieces, scores, bos_id=1)
    for text in ["hello", "the llama", "hello<|im_end|>x", "<|im_start|>hi<|im_end|>",
                 "你好 hello 你好", "", " ", "zzz", "h" * 100, "<|unclosed", "a<|b|>c"]:
        data = text.encode("utf-8")
        for bos in (True, False):
            want = py.encode(text, bos=bos)
            assert nat.encode(data, bos=bos) == want == jpy.encode(text, bos=bos), text


def test_tokenizer_parity_random():
    pieces, scores = _vocab()
    py, jpy = _python_tokenizers(pieces, scores)
    nat = native.NativeTokenizer(pieces, scores, bos_id=1)
    rng = np.random.default_rng(7)
    for trial in range(50):
        data = bytes(rng.integers(0, 256, int(rng.integers(0, 120)), dtype=np.uint8))
        want = py.encode(data, bos=True)
        assert nat.encode(data, bos=True) == want == jpy.encode(data, bos=True), trial


def test_tokenizer_parity_real_vocab(model_path):
    """From a container the port's tokenizer encodes natively, with the
    Python encoder's ids and the JAX package's, eos appended alike."""
    tf = container.TensorFile(model_path)
    tok = Tokenizer.from_container(tf)
    assert tok._native is not None
    os.environ["CALM_TPU_NO_NATIVE"] = "1"
    try:
        pytok = Tokenizer.from_container(tf)
        jtok = JTokenizer.from_container(jcontainer.TensorFile(model_path))
    finally:
        del os.environ["CALM_TPU_NO_NATIVE"]
    assert pytok._native is None
    for text in ["hello world", "the quick brown fox", "fill260<|eot|>"]:
        for bos, eos in ((True, False), (False, True)):
            want = pytok.encode(text, bos=bos, eos=eos)
            assert tok.encode(text, bos=bos, eos=eos) == want == jtok.encode(
                text, bos=bos, eos=eos)


# ---- sampler ----


def test_rng_parity():
    py, jpy, state = XorshiftRng(42), JRng(42), 42
    for _ in range(100):
        v, state = native.rand64(state)
        want = py.next_u32()
        assert (v & 0xFFFFFFFFFFFFFFFF) >> 32 == want == jpy.next_u32()


def test_minp_parity():
    rng = np.random.default_rng(11)
    for trial in range(30):
        n = int(rng.integers(4, 400))
        logits = rng.normal(0, 3, n).astype(np.float32)
        temp = float(rng.uniform(0.1, 1.5))
        minp = float(rng.uniform(0.01, 0.9))
        seed = int(rng.integers(1, 2**31))
        want = Sampler(n, seed=seed, temperature=temp, minp=minp).sample(logits.copy())
        jwant = JSampler(n, seed=seed, temperature=temp, minp=minp).sample(logits.copy())
        got, _ = native.sample_minp(logits, temp, minp, seed)
        assert got == want == jwant, (trial, n, temp, minp)


def test_argmax_parity():
    rng = np.random.default_rng(3)
    for _ in range(20):
        logits = rng.normal(0, 1, 100).astype(np.float32)
        assert native.sample_argmax(logits) == int(np.argmax(logits))
