"""The port's Engine and CLI against calm_tpu.engine on the CPU: greedy
(fp8 and gf4) and host-sampled generations give the same token ids,
stepped and batched prompt ingestion give the logits of JAX's batched
prefill, perplexity and the chat transcript equal JAX's, and the perf
line keeps its format."""

import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from calm_tpu import engine as JE
from calm_tpu import model as JM
from calm_tpu import sampler as jsampler
from calm_tpu_torch import engine as TE
from calm_tpu_torch import sampler as tsampler
from tests.modelgen import tiny_config, write_tiny_model

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERF = re.compile(r"^# \d+ tokens: throughput: [\d.]+ tok/s; latency: [\d.]+ "
                  r"ms/tok; bandwidth: [\d.]+ GB/s; total [\d.]+ sec; "
                  r"#[0-9a-f]{8}$")


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("eng") / "m.calm")
    write_tiny_model(path, tiny_config(dtype="fp8", seq_len=32), seed=5)
    return path


def _record_jax_ids(monkeypatch):
    """Token ids the JAX engine draws: greedy chunks from decode_scan,
    sampled ones from the host Sampler."""
    ids = []
    real_scan, real_sample = JM.decode_scan, jsampler.Sampler.sample

    def scan(*a, **k):
        out = real_scan(*a, **k)
        ids.append(np.asarray(out[0])[0].tolist())
        return out

    def sample(self, logits):
        t = real_sample(self, logits)
        ids.append([t])
        return t

    monkeypatch.setattr(JM, "decode_scan", scan)
    monkeypatch.setattr(jsampler.Sampler, "sample", sample)
    return ids


@pytest.mark.parametrize("prompt,steps", [("hello", 40), ("", 20)])
def test_greedy_generate_matches_jax(model_path, monkeypatch, prompt, steps):
    ids = _record_jax_ids(monkeypatch)
    js = JE.Engine(model_path).generate(prompt, steps, temperature=0)
    ts = TE.Engine(model_path, device="cpu").generate(prompt, steps, temperature=0)
    jids = [t for chunk in ids for t in chunk][:len(ts.ids)]
    assert ts.ids == jids
    assert ts.text == js.text and ts.tokens == js.tokens


def test_gf4_greedy_generate_matches_jax(tmp_path, monkeypatch):
    path = str(tmp_path / "g.calm")
    write_tiny_model(path, tiny_config(dtype="gf4", seq_len=32, dim=64,
                                       hidden_dim=64, head_dim=16, rotary_dim=16),
                     seed=3)
    ids = _record_jax_ids(monkeypatch)
    js = JE.Engine(path).generate("hello there", 40, temperature=0)
    ts = TE.Engine(path, device="cpu").generate("hello there", 40, temperature=0)
    assert ts.ids == [t for chunk in ids for t in chunk][:len(ts.ids)]
    assert ts.text == js.text and len(set(ts.ids)) > 3


def test_sampled_generate_matches_jax_reference_sampling(model_path, monkeypatch):
    ids = _record_jax_ids(monkeypatch)
    js = JE.Engine(model_path).generate("hi", 40, temperature=0.9, minp=0.05,
                                        seed=4, reference_sampling=True)
    ts = TE.Engine(model_path, device="cpu").generate(
        "hi", 40, temperature=0.9, minp=0.05, seed=4, reference_sampling=True)
    assert ts.ids == [t for chunk in ids for t in chunk]
    assert ts.text == js.text and len(set(ts.ids)) > 3


def _min_p_support(logits, temperature, minp):
    """The ids min-p keeps: logit >= max + log(minp) * temperature."""
    return set(np.nonzero(logits >= logits.max() + np.log(minp) * temperature)[0].tolist())


def test_sampled_generate_defaults_to_device_sampling(model_path, monkeypatch):
    """-t > 0 samples on the device by default (decode_loop's sampling, the host
    Sampler untouched); every id lies in the min-p support set of its
    step's logits, replayed by stepping the same ids; one seed gives one
    generation, and another seed another."""
    drawn = []
    real = TE.M.decode_loop

    def spy(*a, **k):
        out = real(*a, **k)
        assert a[6] is not None  # every chunk sampled
        drawn.append(out[0][0].tolist())
        return out
    monkeypatch.setattr(TE.M, "decode_loop", spy)
    monkeypatch.setattr(tsampler.Sampler, "sample", None)  # the host path is unused
    eng = TE.Engine(model_path, device="cpu")
    t, mp = 1.3, 0.05
    st = eng.generate("hi", 40, temperature=t, minp=mp, seed=4)
    assert st.ids == [i for chunk in drawn for i in chunk][:len(st.ids)]
    prompt = eng.tokenizer.encode("hi", bos=True)
    eng.reset()
    logits = eng.prefill_tokens(prompt)
    sizes = []
    for pos, nxt in enumerate(st.ids, start=len(prompt)):
        keep = _min_p_support(logits, t, mp)
        sizes.append(len(keep))
        assert nxt in keep, (pos, nxt, sorted(keep))
        logits = eng.step(nxt, pos)
    # the draws had a choice, and the sets leave ids out: the check can fail
    assert max(sizes) > 1 and min(sizes) < len(logits) and len(set(st.ids)) > 3
    again = TE.Engine(model_path, device="cpu").generate("hi", 40, temperature=t,
                                                         minp=mp, seed=4)
    other = TE.Engine(model_path, device="cpu").generate("hi", 40, temperature=t,
                                                         minp=mp, seed=5)
    assert again.ids == st.ids and other.ids != st.ids


def test_chat_samples_on_the_device_by_default(model_path, monkeypatch):
    """chat_loop's default reply decodes in device-sampled chunks (the host
    Sampler unused), bounded by max_reply; one seed, one transcript."""
    monkeypatch.setattr(tsampler.Sampler, "sample", None)

    def run(seed):
        out = io.StringIO()
        TE.chat_loop(TE.Engine(model_path, device="cpu"), "", "hello", temperature=1.3,
                     minp=0.05, seed=seed, read_line=lambda: (_ for _ in ()).throw(EOFError),
                     write=out.write, max_reply=20)
        return out.getvalue()
    text = run(2)
    assert text.count("Assistant: ") == 1 and "\n\n[" in text
    eng = TE.Engine(model_path, device="cpu")
    prompt = eng.tokenizer.encode(TE.chat_template(eng.tokenizer, False).format(
        user="hello"), bos=True)
    n = int(re.search(r"\[(\d+)/32\] User: $", text).group(1))
    assert len(prompt) - 1 < n <= len(prompt) - 1 + 20  # stopped by eos or at 20
    assert run(2) == text


def test_cli_reference_sampling_flag(model_path):
    """--reference-sampling takes the host xorshift path: the CLI decodes
    what Engine.generate(reference_sampling=True) decodes."""
    env = dict(os.environ, CALM_CPU="1")
    args = [sys.executable, "-m", "calm_tpu_torch.cli", model_path, "-t", "0.9",
            "-p", "0.05", "-s", "4", "-n", "24", "-i", "hi"]
    r = subprocess.run(args + ["--reference-sampling"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    want = TE.Engine(model_path, device="cpu").generate(
        "hi", 24, temperature=0.9, minp=0.05, seed=4, reference_sampling=True)
    # the fingerprint of the last step's logits: the same ids to the end
    assert r.stderr.strip().splitlines()[-1].endswith(f"#{want.logits_hash:08x}"), r.stderr


def test_stepped_prefill_matches_batched_prefill(model_path):
    toks = [1, 50, 60, 70, 80, 90, 100, 110, 120, 5]
    je = JE.Engine(model_path)
    want = je.prefill_tokens(toks)
    te = TE.Engine(model_path, device="cpu")
    got = te.prefill_tokens(toks)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
    # both caches now continue identically
    np.testing.assert_allclose(te.step(7, len(toks)), je.step(7, len(toks)),
                               rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_perplexity_matches_jax(model_path):
    """Three windows of 16 tokens, the last one short; f32 logits on both
    sides, so the running mean and its error agree to 1e-4."""
    text = "the quick brown fox jumps over the lazy dog, again."
    want = JE.Engine(model_path).perplexity(text, steps=16)
    lines = []
    got = TE.Engine(model_path, device="cpu").perplexity(text, steps=16,
                                                         progress=lines.append)
    assert got[2] == want[2] == len(text)  # byte tokens: one per char, + bos
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-4)
    assert len(lines) == 4 and lines[-1].startswith(f"# progress ({got[2]}/")


def test_chat_transcript_matches_jax(model_path):
    """Two turns, sampled on the host with the same seed: the port's
    chat_loop writes what JAX's writes with reference_sampling=True."""
    def run(loop, engine, **kw):
        out = io.StringIO()
        lines = iter(["and then?"])

        def read_line():
            try:
                return next(lines)
            except StopIteration:
                raise EOFError from None
        loop(engine, "be brief", "hello", temperature=1.5, minp=0.01, seed=11,
             read_line=read_line, write=out.write, **kw)
        return out.getvalue()

    want = run(JE.chat_loop, JE.Engine(model_path), reference_sampling=True)
    got = run(TE.chat_loop, TE.Engine(model_path, device="cpu"), reference_sampling=True)
    assert got == want
    assert got.count("Assistant: ") == 2 and "User: " in got
    assert TE.chat_template(TE.Engine(model_path, device="cpu").tokenizer,
                            True) == JE._LLAMA2[0]


def test_perf_line_and_accounting(model_path):
    te = TE.Engine(model_path, device="cpu")
    je = JE.Engine(model_path)
    assert (te.n_bandwidth, te.n_bytes, te.n_params) == (
        je.n_bandwidth, je.n_bytes, je.n_params)
    assert te.banner() == je.banner()
    st = te.generate("hi", 6, temperature=0)
    assert PERF.match(st.perf_line()), st.perf_line()
    assert PERF.match(JE.GenStats(6, 0.5, 10**6, 7, "").perf_line())
    c = te.cfg
    assert TE.kv_cache_bytes(c, 8, 40) == JE.kv_cache_bytes(c, 8, 40)


def test_long_context_picks_fp8_kv(tmp_path):
    path = str(tmp_path / "long.calm")
    write_tiny_model(path, tiny_config(dtype="fp16", seq_len=16), seed=2)
    te = TE.Engine(path, context=4097, device="cpu")
    assert te.kv_dtype == "fp8" and te.cache.k.dtype == torch.float8_e5m2
    assert TE.Engine(path, context=4096, device="cpu").kv_dtype == "bf16"


def test_sampler_copy_is_bit_compatible():
    a, b = jsampler.XorshiftRng(123), tsampler.XorshiftRng(123)
    assert [a.next_u32() for _ in range(50)] == [b.next_u32() for _ in range(50)]
    logits = np.linspace(-3, 3, 40).astype(np.float32)
    sa = jsampler.Sampler(40, 9, 0.8, 0.05)
    sb = tsampler.Sampler(40, 9, 0.8, 0.05)
    assert [sa.sample(logits) for _ in range(20)] == [sb.sample(logits) for _ in range(20)]


def test_cli_runs_on_cpu(model_path):
    env = dict(os.environ, CALM_CPU="1", CALM_TOKENS="1")
    r = subprocess.run([sys.executable, "-m", "calm_tpu_torch.cli", model_path,
                        "-t", "0", "-n", "8", "-i", "hello"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("# ") and "# device: cpu" in r.stdout
    assert PERF.match(r.stderr.strip().splitlines()[-1]), r.stderr
    txt = os.path.join(os.path.dirname(model_path), "ppl.txt")
    with open(txt, "w") as f:
        f.write("ABCDABCDABCDABCD")
    r = subprocess.run([sys.executable, "-m", "calm_tpu_torch.cli", model_path,
                        "-x", txt, "-n", "8"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert re.search(r"^# perplexity: [\d.]+ ± [\d.]+ \(", r.stdout, re.M), r.stdout


def test_cli_chat_on_cpu(model_path):
    env = dict(os.environ, CALM_CPU="1")
    r = subprocess.run([sys.executable, "-m", "calm_tpu_torch.cli", model_path,
                        "-y", "be brief", "-n", "6", "-s", "3"], cwd=ROOT, env=env,
                       input="hi\n", capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.count("Assistant: ") == 1 and "] User: " in r.stdout


def test_cli_sequences_match_jax(model_path, capsys, monkeypatch):
    """-r 2 greedy: the JAX CLI's generated text twice, and two perf lines
    with one fingerprint (the second sequence starts from a reset cache)."""
    from calm_tpu import cli as jcli
    from calm_tpu_torch import cli as tcli

    args = [model_path, "-t", "0", "-n", "12", "-r", "2", "-i", "hello"]
    jcli.main(args)
    want = capsys.readouterr()
    monkeypatch.setenv("CALM_CPU", "1")
    tcli.main(args)
    got = capsys.readouterr()

    def text(out):
        return [line for line in out.splitlines() if not line.startswith("# ")]
    assert text(got.out) == text(want.out) and len(text(got.out)) >= 2
    assert text(got.out)[0] == text(got.out)[1]
    perf = got.err.strip().splitlines()[-2:]
    assert all(PERF.match(p) for p in perf), got.err
    assert perf[0].split("#")[-1] == perf[1].split("#")[-1]


@pytest.fixture(scope="module")
def draft_path(tmp_path_factory):
    """A draft of other random weights beside ``model_path``'s target."""
    path = str(tmp_path_factory.mktemp("draft") / "d.calm")
    write_tiny_model(path, tiny_config(dtype="fp8", seq_len=32), seed=9)
    return path


SPEC = re.compile(r"^# speculative: acceptance [\d.]+ over \d+ rounds \(gamma \d+\)$")


@pytest.mark.parametrize("draft", ["self", "other"])
def test_cli_draft_gamma_matches_jax(model_path, draft_path, capsys, monkeypatch, draft):
    """--draft --gamma 3 -t 0 -r 2: the JAX CLI's text and its draft banner
    and speculative lines, the text of a run without a draft, and two perf
    lines with one fingerprint."""
    from calm_tpu import cli as jcli
    from calm_tpu_torch import cli as tcli

    d = model_path if draft == "self" else draft_path
    args = [model_path, "-t", "0", "-n", "16", "-r", "2", "-i", "hello"]
    jcli.main(args + ["--draft", d, "--gamma", "3"])
    want = capsys.readouterr()
    monkeypatch.setenv("CALM_CPU", "1")
    tcli.main(args)
    plain = capsys.readouterr()
    tcli.main(args + ["--draft", d, "--gamma", "3"])
    got = capsys.readouterr()

    def text(out):
        return [line for line in out.splitlines() if not line.startswith("# ")]
    assert text(got.out) == text(want.out) == text(plain.out)
    banners = [line for line in got.out.splitlines() if line.startswith(f"# {d}:")]
    assert len(banners) == 1 + (d == model_path)  # the target's, then the draft's
    spec = [line for line in got.err.splitlines() if line.startswith("# speculative")]
    assert spec == [line for line in want.err.splitlines() if line.startswith("# speculative")]
    assert len(spec) == 2 and all(SPEC.match(s) for s in spec)
    if draft == "self":
        assert spec[0].startswith("# speculative: acceptance 1.00")
    perf = [line for line in got.err.splitlines() if line.startswith("# ") and "tokens:" in line]
    assert len(perf) == 2 and all(PERF.match(p) for p in perf)
    assert perf[0].split("#")[-1] == perf[1].split("#")[-1]


def test_cli_precise_draft_leaves_the_flag_as_jax(model_path, draft_path, capsys,
                                                  monkeypatch):
    """--precise --draft: the draft Engine is made as calm_tpu/cli.py:119
    makes it, without precise, so it switches the process-wide flag off
    again, in both packages (a quirk of the reference, kept); --precise
    alone leaves it on."""
    from calm_tpu import cli as jcli
    from calm_tpu.ops import qmm as jqmm
    from calm_tpu_torch import cli as tcli
    from calm_tpu_torch.ops import qmm as tqmm

    args = [model_path, "-t", "0", "-n", "14", "-i", "hello", "--precise"]
    monkeypatch.setenv("CALM_CPU", "1")
    try:
        states = []
        for extra in ([], ["--draft", draft_path]):
            jcli.main(args + extra)
            tcli.main(args + extra)
            states.append((jqmm._PRECISE, tqmm._PRECISE))
        capsys.readouterr()
    finally:
        jqmm.enable_precise(False)
        tqmm.enable_precise(False)
    assert states == [(True, True), (False, False)]
