"""One-command BASELINE acceptance gate on the port (the port of
``tools/accept.py``).

The reference's acceptance gate is end-to-end on real checkpoints: convert,
greedy-decode with a deterministic logits hash, perplexity on a fixed text
(~0.5% fp8 penalty vs fp16; reference README.md:66, harness
src/run.c:258-316), and the tok/s + GB/s perf line (src/run.c:249-253).
This tool runs that gate for every BASELINE.json config in one command,
on the port's converter (``tools.convert``) and ``Engine``:

    python -m calm_tpu_torch.tools.accept <ckpt_root>     # HF checkpoint dirs
    python -m calm_tpu_torch.tools.accept --selftest      # synthetic tiny checkpoints
    python -m calm_tpu_torch.tools.accept <root> --configs 2,3 --steps 128

<ckpt_root> holds one HF directory per model (config.json +
*.safetensors + tokenizer.json); configs resolve their directory by
fuzzy name match (e.g. any dir containing "mistral" and "7b").
--selftest synthesizes tiny HF checkpoints with ``transformers`` (and
--trained trains two), as ``tools/accept.py`` does, and runs the same
pipeline; without ``transformers`` both exit 2 and say so, and the tool
runs on a checkpoint root (``utils.modelgen.write_hf_checkpoint`` writes
one with torch alone).

Per config the gate is:
  convert   HF -> .calm at the config's dtype(s) (``tools.convert``)
  hash      greedy 32-token decode twice -> identical logits hash
            (the reference's determinism contract, run.c:242-253)
  ppl       perplexity on tools/pplx.txt per dtype + delta vs the
            config's higher-precision anchor
  bench     first-32 tok/s + achieved GB/s from the engine's own
            bandwidth accounting

Config 1's cpu-crosscheck row runs ``python -m calm_tpu_torch.cli`` on the
fp16 container under ``CALM_CPU=1`` (the plain PyTorch path). When the
gate itself runs on the CPU (``CALM_CPU=1``), the row passes when the two
runs' logits hashes are equal, as ``tools/accept.py``'s. On the card the
kernels sum in another order than the CPU's plain path, so the hashes
differ; there the row compares the greedy ids instead (the CLI prints
them under ``CALM_TOKENS=1``): they must be equal, and where they first
differ the card's two largest logits at that position must lie within
1e-3 of the logits' scale (max |logit|), a near-tie that the operands'
rounding may decide either way (``chip_smoke.same_generation``'s rule).
Nothing else is loosened.

Config 5's sharded row decodes one greedy step tp=2 over
``calm_tpu_torch.parallel`` (two ranks, a GPU each) when
``torch.cuda.device_count() >= 2``, else it is deferred.

Exit status is nonzero if any MECHANICAL gate fails (convert error, hash
nondeterminism, non-finite ppl). Quality thresholds (the ~0.5% fp8 delta)
are informational on synthetic weights (random models have no trained
structure) and enforced only with --enforce-deltas (for real
checkpoints). The model runs on the GPU; ``CALM_CPU=1`` runs it on the
CPU, and without a GPU and without ``CALM_CPU=1`` the tool exits 1.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from calm_tpu_torch.utils.modelgen import hf_tokenizer_json

PPLX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "tools",
                    "pplx.txt")
NEAR_TIE = 1e-3  # the card's top-2 margin, of max |logit|, below which ids may part


# -- config matrix (BASELINE.json "configs") ---------------------------------

CONFIGS = [
    {
        "id": 1,
        "name": "TinyLlama 1.1B fp16 greedy (CPU-path cross-check)",
        "match": ("tinyllama",),
        "dtypes": ["fp16"],
        "anchor": None,
        "cpu_crosscheck": True,  # config text: "via CPU infer.c path"
    },
    {
        "id": 2,
        "name": "Mistral-7B fp8 (e5m2), fp8 KV",
        "match": ("mistral", "7b"),
        "dtypes": ["fp16", "fp8"],
        "anchor": "fp16",  # published ~0.5% fp8 ppl penalty
        "kv_dtype": {"fp8": "fp8"},
        "delta_budget": 0.015,  # 3x published headroom for corpus variance
    },
    {
        "id": 3,
        "name": "Llama-3 8B gf4 vs fp16 perplexity",
        "match": ("llama", "8b"),
        "dtypes": ["fp16", "gf4"],
        "anchor": "fp16",
        "delta_budget": 0.10,  # gf4 "carries a perplexity penalty"
    },
    {
        "id": 4,
        "name": "Mixtral 8x7B MoE top-2 gf4",
        "match": ("mixtral",),
        "dtypes": ["gf4"],
        "anchor": None,
        "moe": True,
    },
    {
        "id": 5,
        "name": "Yi-1.5 34B fp8 sharded decode",
        "match": ("yi", "34b"),
        "dtypes": ["fp8"],
        "anchor": None,
        "sharded": True,
    },
]


def find_ckpt_dir(root: str, patterns) -> str | None:
    cands = []
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        if not os.path.isdir(d):
            continue
        low = name.lower()
        if all(p in low for p in patterns):
            if os.path.exists(os.path.join(d, "config.json")):
                cands.append(d)
    return cands[0] if cands else None


# -- selftest checkpoint synthesis (tools/accept.py:133-290) -----------------

def synthesize(root: str):
    """Tiny HF checkpoints, one per config, written like real downloads."""
    from calm_tpu_torch import container

    os.makedirs(root, exist_ok=True)
    dense = {
        "architectures": ["LlamaForCausalLM"],
        "hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "vocab_size": 272, "max_position_embeddings": 128,
        "bos_token_id": 1, "eos_token_id": 2, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-5, "hidden_act": "silu",
        "tie_word_embeddings": False,
    }
    moe = {
        "architectures": ["MixtralForCausalLM"],
        "hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "vocab_size": 272, "max_position_embeddings": 128,
        "bos_token_id": 1, "eos_token_id": 2, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-5, "hidden_act": "silu",
        "num_local_experts": 4, "num_experts_per_tok": 2,
        "tie_word_embeddings": False,
    }
    plan = [("tinyllama-1.1b", dense, 11), ("mistral-7b", dense, 12),
            ("llama-3-8b", dense, 13), ("mixtral-8x7b", moe, 14),
            ("yi-1.5-34b", dense, 15)]
    for name, hf_cfg, seed in plan:
        d = os.path.join(root, name)
        if os.path.exists(os.path.join(d, "model.safetensors")):
            continue
        os.makedirs(d, exist_ok=True)
        torch.manual_seed(seed)
        if hf_cfg is moe:
            from transformers import MixtralConfig, MixtralForCausalLM
            cfg = MixtralConfig(**{k: v for k, v in hf_cfg.items()
                                   if k != "architectures"})
            model = MixtralForCausalLM(cfg).eval()
        else:
            from transformers import LlamaConfig, LlamaForCausalLM
            cfg = LlamaConfig(**{k: v for k, v in hf_cfg.items()
                                 if k != "architectures"},
                              attention_bias=False)
            model = LlamaForCausalLM(cfg).eval()
        tensors = {k: v.detach().float().numpy()
                   for k, v in model.state_dict().items()
                   if not k.endswith("rotary_emb.inv_freq")}
        container.write_tensors(os.path.join(d, "model.safetensors"),
                                tensors, {})
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(hf_cfg, f)
        hf_tokenizer_json(d, hf_cfg["vocab_size"])
        print(f"# synthesized {d}")


def split_pplx(root: str, pplx: str, frac: float = 0.8):
    """Held-out split of the ppl corpus: the tiny model TRAINS on the first
    ``frac`` of the bytes and the acceptance ppl runs on the remainder —
    measuring quantization deltas on memorized text would understate them
    (a confident memorizer saturates; unseen text exercises the logit
    tails). Byte-fallback tokenization is 1:1 with bytes, so a byte split
    IS a token split. Returns (train_ids, heldout_text_path)."""
    with open(pplx, "rb") as f:
        data = f.read()
    cut = int(len(data) * frac)
    os.makedirs(root, exist_ok=True)
    held = os.path.join(root, "pplx_heldout.txt")
    with open(held, "wb") as f:
        f.write(data[cut:])
    train_ids = np.frombuffer(data[:cut], np.uint8).astype(np.int64) + 3
    return train_ids, held


def train_tiny(root: str, pplx: str, steps: int = 400):
    """Structured-synthetic fallback for real-checkpoint acceptance
    (no-network environments): TRAIN the tiny llama on the FIRST 80% of
    the published perplexity text so its logits carry real structure — on
    random weights a format's quantization error is invisible in ppl
    (near-uniform logits), on a trained model the fp16 <= fp8 <= gf4
    ordering and the fp8 ~0.5%-class delta become measurable. The
    acceptance ppl then runs on the HELD-OUT last 20% (split_pplx).
    Reference quality contract: README.md:66-68, harness
    src/run.c:258-316. Returns the held-out text path."""
    from calm_tpu_torch import container

    os.makedirs(root, exist_ok=True)
    # ~8x the round-4 model (4L/256h): quantization-noise statistics on a
    # 1M-param toy differ wildly from real models; bigger is closer
    hf_cfg = {
        "architectures": ["LlamaForCausalLM"],
        "hidden_size": 384, "intermediate_size": 1024,
        "num_hidden_layers": 6,
        "num_attention_heads": 6, "num_key_value_heads": 2,
        "vocab_size": 272, "max_position_embeddings": 128,
        "bos_token_id": 1, "eos_token_id": 2, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-5, "hidden_act": "silu",
        "tie_word_embeddings": False,
    }
    ids, held = split_pplx(root, pplx)
    seq = 128
    n = (len(ids) - 1) // seq
    x = torch.from_numpy(np.stack([ids[i * seq:(i + 1) * seq]
                                   for i in range(n)]))
    y = torch.from_numpy(np.stack([ids[i * seq + 1:(i + 1) * seq + 1]
                                   for i in range(n)]))

    for name, seed in (("mistral-7b", 21), ("llama-3-8b", 22)):
        d = os.path.join(root, name)
        marker = os.path.join(d, ".trained")
        if os.path.exists(marker):
            continue
        os.makedirs(d, exist_ok=True)
        torch.manual_seed(seed)
        from transformers import LlamaConfig, LlamaForCausalLM
        cfg = LlamaConfig(**{k: v for k, v in hf_cfg.items()
                             if k != "architectures"},
                          attention_bias=False)
        model = LlamaForCausalLM(cfg).train()
        opt = torch.optim.AdamW(model.parameters(), lr=2e-3,
                                weight_decay=0.01)
        lossf = torch.nn.CrossEntropyLoss()
        g = torch.Generator().manual_seed(seed)
        t0 = time.time()
        for it in range(steps):
            idx = torch.randint(0, n, (16,), generator=g)
            out = model(input_ids=x[idx]).logits
            loss = lossf(out.reshape(-1, 272), y[idx].reshape(-1))
            opt.zero_grad()
            loss.backward()
            opt.step()
            if it % 100 == 0 or it == steps - 1:
                print(f"#   train {name} step {it}: loss {loss.item():.3f} "
                      f"({time.time() - t0:.0f}s)")
        model.eval()
        tensors = {k: v.detach().float().numpy()
                   for k, v in model.state_dict().items()
                   if not k.endswith("rotary_emb.inv_freq")}
        container.write_tensors(os.path.join(d, "model.safetensors"),
                                tensors, {})
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(hf_cfg, f)
        hf_tokenizer_json(d, hf_cfg["vocab_size"])
        with open(marker, "w") as f:
            f.write("trained\n")
        print(f"# trained {d}")
    return held


# -- the gate ----------------------------------------------------------------

class Gate:
    def __init__(self):
        self.rows = []
        self.ppls = {}      # (cfg_id, dtype) -> (ppl, se, n_tokens)
        self.deltas = {}    # (cfg_id, dtype) -> fractional delta vs anchor
        self.perf = {}      # (cfg_id, dtype) -> (tok_s, gb_s)
        self.mechanical_fail = False
        self.delta_fail = False

    def row(self, cfg_id, stage, ok, detail):
        self.rows.append((cfg_id, stage, ok, detail))
        mark = "ok " if ok else "FAIL"
        print(f"  [{mark}] {stage}: {detail}")
        if not ok:
            self.mechanical_fail = True


def _cli_ids(out: str) -> list[int] | None:
    """The ids of the CLI's ``# ids:`` line (``CALM_TOKENS=1``), or None."""
    m = re.search(r"^# ids:((?: \d+)*)$", out, re.M)
    return None if m is None else [int(t) for t in m.group(1).split()]


def near_tie_margin(eng, prompt: str, ids: list[int], n: int) -> float:
    """The card's top-2 logit gap, of max |logit|, at generated position
    ``n``: the engine replays ``generate``'s steps (its prompt prefilled,
    then a step a token) on its own ids up to there."""
    toks = eng.tokenizer.encode(prompt, bos=True)
    eng.reset()
    if len(toks) > 1:
        eng.prefill_tokens(toks[:-1])
    pos, token = len(toks) - 1, toks[-1]
    for i in range(n + 1):
        logits = eng.step(token, pos)
        if i < n:
            token, pos = ids[i], pos + 1
    top = np.sort(logits)[-2:]
    return float((top[1] - top[0]) / np.abs(logits).max())


def cpu_crosscheck(eng, out: str, a, gate, cfg_id, args):
    """Config 1's cpu-crosscheck row (the module's docstring): the CLI on
    the CPU against this run, by logits hash on the CPU, by greedy ids up
    to a near-tie on the card."""
    env = dict(os.environ, CALM_CPU="1", CALM_TOKENS="1")
    r = subprocess.run(
        [sys.executable, "-m", "calm_tpu_torch.cli", out, "-t", "0",
         "-n", str(args.hash_steps), "-i", "The "],
        capture_output=True, text=True, env=env, timeout=1800)
    got = None
    for line in r.stderr.splitlines():
        if "#" in line and "tokens:" in line:
            got = int(line.rsplit("#", 1)[1].strip(), 16)
    if got is None:
        gate.row(cfg_id, "cpu-crosscheck", False, f"no perf line: {r.stderr[-200:]}")
        return
    if eng.device.type == "cpu":
        gate.row(cfg_id, "cpu-crosscheck", got == a.logits_hash, f"cpu #{got:08x}")
        return
    ids = _cli_ids(r.stdout)
    if ids is None:
        gate.row(cfg_id, "cpu-crosscheck", False, f"no ids line: {r.stdout[-200:]}")
        return
    n = next((i for i, (g, c) in enumerate(zip(a.ids, ids)) if g != c), None)
    if n is None:
        gate.row(cfg_id, "cpu-crosscheck", len(ids) == len(a.ids),
                 f"cpu #{got:08x}; greedy ids equal ({len(ids)} ids)")
        return
    m = near_tie_margin(eng, "The ", a.ids, n)
    gate.row(cfg_id, "cpu-crosscheck", m < NEAR_TIE,
             f"cpu #{got:08x}; greedy ids equal up to {n}, then the card's top-2 "
             f"margin {m:.2e} of scale (near-tie below {NEAR_TIE:g})")


def _tp_greedy(rank, path, kv, device):
    """A rank of the sharded row: one tp=2 decode step of token 1 at
    position 0 on this rank's shard; the greedy id (every rank's)."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch.config import ModelConfig
    from calm_tpu_torch.container import TensorFile
    from calm_tpu_torch.parallel import ShardingPlan, make_mesh
    from calm_tpu_torch.parallel.sharding import (load_weights_sharded, local_cache,
                                                  sharded_decode_step)

    tf = TensorFile(path)
    cfg = ModelConfig.from_metadata(tf.metadata)
    mesh = make_mesh(tp=2, device=device)
    plan = ShardingPlan(tp="tp")
    ws = load_weights_sharded(tf, cfg, mesh, plan)
    kv = kv or ("fp8" if cfg.seq_len > 4096 else "bf16")
    cache = local_cache(cfg, 1, M.KV_DTYPES[kv], mesh, plan)
    logits, _ = sharded_decode_step(cfg, mesh, plan)(
        ws, torch.tensor([1], device=mesh.device), 0, cache)
    return int(logits[0].argmax())


def tp_greedy(path: str, kv, device=None) -> list[int]:
    """Each rank's greedy id of :func:`_tp_greedy` over two spawned ranks
    (each on its own GPU unless ``device`` is given)."""
    from calm_tpu_torch.parallel import spawn

    return spawn(_tp_greedy, 2, path, kv, device, device=device)


def run_config(cfg, ckpt_dir: str, gate: Gate, args):
    from calm_tpu_torch.engine import Engine
    from calm_tpu_torch.tools import convert as convert_mod

    print(f"\n## config {cfg['id']}: {cfg['name']}\n#    {ckpt_dir}")
    ppls = {}
    for dtype in cfg["dtypes"]:
        out = os.path.join(ckpt_dir, f"model-{dtype}.calm")
        # convert (cached by mtime so reruns are cheap)
        src = os.path.join(ckpt_dir, "model.safetensors")
        if (not os.path.exists(out)
                or os.path.getmtime(out) < os.path.getmtime(src)):
            try:
                convert_mod.main([out, ckpt_dir, "--dtype", dtype])
            except Exception as e:  # noqa: BLE001 — report, don't crash gate
                gate.row(cfg["id"], f"convert[{dtype}]", False, repr(e))
                continue
        gate.row(cfg["id"], f"convert[{dtype}]", True, out)

        kv = (cfg.get("kv_dtype") or {}).get(dtype)
        eng = Engine(out, kv_dtype=kv, device=args.device)

        # golden hash: greedy decode twice, identical logits hash
        a = eng.generate("The ", steps=args.hash_steps, temperature=0.0)
        eng.reset()
        b = eng.generate("The ", steps=args.hash_steps, temperature=0.0)
        gate.row(cfg["id"], f"hash[{dtype}]",
                 a.logits_hash == b.logits_hash and a.tokens > 0,
                 f"#{a.logits_hash:08x} x2, {a.tokens} toks")

        if cfg.get("cpu_crosscheck") and dtype == "fp16":
            cpu_crosscheck(eng, out, a, gate, cfg["id"], args)

        # perplexity on the published text
        with open(args.pplx) as f:
            text = f.read()[: args.ppl_chars]
        eng.reset()
        ppl, err, n = eng.perplexity(text, steps=args.steps)
        ppls[dtype] = ppl
        gate.ppls[(cfg["id"], dtype)] = (ppl, err, n)
        gate.row(cfg["id"], f"ppl[{dtype}]", math.isfinite(ppl) and n > 0,
                 f"{ppl:.4f} ± {err:.4f} over {n} toks")

        # bench: first-32 decode rate from the engine's own accounting
        eng.reset()
        s = eng.generate("The quick brown fox", steps=32, temperature=0.0)
        gate.perf[(cfg["id"], dtype)] = (s.tok_s, s.gb_s)
        gate.row(cfg["id"], f"bench[{dtype}]", s.tokens > 0,
                 f"{s.tok_s:.1f} tok/s, {s.gb_s:.1f} GB/s")

        if cfg.get("sharded"):
            if torch.cuda.device_count() >= 2 and eng.device.type == "cuda":
                # tensor-sharded decode must reproduce the greedy tokens
                eng.reset()
                want = [int(np.argmax(eng.step(1, 0)))]
                got = tp_greedy(out, kv)[:1]
                gate.row(cfg["id"], f"sharded[{dtype}]", got == want,
                         f"tp greedy tokens {got} == {want}")
            else:
                gate.row(cfg["id"], f"sharded[{dtype}]", True,
                         "single device: sharded gate deferred "
                         "(run under a multi-chip mesh)")
        del eng

    anchor = cfg.get("anchor")
    if anchor and anchor in ppls:
        for dtype in cfg["dtypes"]:
            if dtype == anchor or dtype not in ppls:
                continue
            delta = ppls[dtype] / ppls[anchor] - 1.0
            gate.deltas[(cfg["id"], dtype)] = delta
            budget = cfg.get("delta_budget", 0.10)
            if args.trained:
                # trained-tiny mode: ~1.4k held-out eval tokens give a ppl
                # SE of several percent (measured ±8% at 9.7M params), so
                # reference-class budgets (0.5-1.5%) are below the noise
                # floor — gate at 2x-SE-class 4% instead; the tight budgets
                # apply to real checkpoints where ppl is precise
                budget = max(budget, 0.04)
            ok = (not args.enforce_deltas) or delta <= budget
            line = (f"{dtype} vs {anchor}: {delta * 100:+.2f}% "
                    f"(budget {budget * 100:.1f}%"
                    + (", informational on synthetic weights)" if not
                       args.enforce_deltas else ")"))
            gate.row(cfg["id"], f"delta[{dtype}]", ok, line)
            if args.enforce_deltas and not ok:
                gate.delta_fail = True


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m calm_tpu_torch.tools.accept",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("root", nargs="?", help="directory of HF checkpoint dirs")
    ap.add_argument("--selftest", action="store_true",
                    help="synthesize tiny checkpoints and run the full gate")
    ap.add_argument("--trained", action="store_true",
                    help="no-network quality fallback: TRAIN tiny llamas "
                         "on the ppl text, then run the gate with deltas "
                         "ENFORCED (format ordering is meaningful on a "
                         "trained model, unlike --selftest's random one)")
    ap.add_argument("--train-steps", type=int, default=1500)
    ap.add_argument("--configs", default="",
                    help="comma-separated config ids (default: all found)")
    ap.add_argument("--steps", type=int, default=0,
                    help="ppl chunk length (0 = model context)")
    ap.add_argument("--ppl-chars", type=int, default=0,
                    help="truncate the ppl text (0 = auto: 2000 for "
                         "--selftest, full text otherwise)")
    ap.add_argument("--hash-steps", type=int, default=32)
    ap.add_argument("--pplx", default=PPLX)
    ap.add_argument("--enforce-deltas", action="store_true",
                    help="fail on ppl-delta budget violations (use on real "
                         "checkpoints, not synthetic ones)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the gate results (rows, ppls, deltas, "
                         "backend) as a committed-artifact JSON")
    args = ap.parse_args(argv)

    cpu = os.environ.get("CALM_CPU", "0") == "1"
    if not cpu and not torch.cuda.is_available():
        print("accept: no CUDA GPU available (CALM_CPU=1 runs on the CPU)", file=sys.stderr)
        return 1
    args.device = "cpu" if cpu else "cuda"
    if args.trained or args.selftest:
        try:
            import transformers  # noqa: F401
        except ImportError:
            print(f"accept: --{'trained' if args.trained else 'selftest'} builds its "
                  "checkpoints with `transformers`, which is not installed; give a "
                  "checkpoint root instead (utils.modelgen.write_hf_checkpoint writes "
                  "one with torch alone)", file=sys.stderr)
            return 2

    if args.trained:
        args.root = args.root or os.path.join(tempfile.gettempdir(), "calm_accept_trained")
        if not args.configs:
            args.configs = "2,3"  # the two delta-anchored configs
        args.enforce_deltas = True
        # the gate's ppl runs on the HELD-OUT 20% the training never saw
        args.pplx = train_tiny(args.root, args.pplx, steps=args.train_steps)
    elif args.selftest:
        args.root = args.root or os.path.join(tempfile.gettempdir(), "calm_accept_selftest")
        if not args.ppl_chars:
            args.ppl_chars = 2000
        synthesize(args.root)
    elif not args.root:
        ap.error("need a checkpoint root (or --selftest)")
    if not args.ppl_chars:
        args.ppl_chars = 1 << 30

    want = ({int(x) for x in args.configs.split(",") if x}
            if args.configs else None)
    gate = Gate()
    t0 = time.time()
    ran = skipped = 0
    for cfg in CONFIGS:
        if want and cfg["id"] not in want:
            continue
        d = find_ckpt_dir(args.root, cfg["match"])
        if d is None:
            print(f"\n## config {cfg['id']}: {cfg['name']}\n"
                  f"#    SKIPPED: no dir matching {cfg['match']} in "
                  f"{args.root}")
            skipped += 1
            continue
        run_config(cfg, d, gate, args)
        ran += 1

    n_ok = sum(1 for r in gate.rows if r[2])
    verdict = ("PASS" if not (gate.mechanical_fail or gate.delta_fail)
               else "FAIL")
    print(f"\n# accept: {verdict} — {n_ok}/{len(gate.rows)} gates ok, "
          f"{ran} configs run, {skipped} skipped, {time.time() - t0:.0f}s")
    if args.json:
        out = {
            "verdict": verdict,
            "backend": "cpu" if cpu else "cuda",
            "device": "cpu" if cpu else torch.cuda.get_device_name(),
            "mode": ("trained-heldout" if args.trained
                     else "selftest" if args.selftest else "checkpoints"),
            "train_steps": args.train_steps if args.trained else None,
            "rows": [{"config": c, "stage": s, "ok": ok, "detail": d}
                     for c, s, ok, d in gate.rows],
            "ppl": {f"cfg{c}.{dt}": {"ppl": p, "se": e, "tokens": n}
                    for (c, dt), (p, e, n) in gate.ppls.items()},
            "delta_vs_anchor": {f"cfg{c}.{dt}": d
                                for (c, dt), d in gate.deltas.items()},
            "decode": {f"cfg{c}.{dt}": {"tok_s": t, "gb_s": g}
                       for (c, dt), (t, g) in gate.perf.items()},
        }
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"# wrote {args.json}")
    return 0 if verdict == "PASS" else 1


if __name__ == "__main__":
    sys.exit(main())
