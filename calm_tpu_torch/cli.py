"""Command-line entry point: generate, perplexity, chat (the port of
``calm_tpu.cli``).

Flag-compatible with the reference CLI (src/run.c:421-490):
  -t temperature   -p min-p   -s seed   -n steps   -r sequences
  -c context   -i prompt (- reads stdin)   -x ppl-file   -y system-prompt
  --kv KV cache dtype

Env hooks:
  CALM_TOKENS=1  dump prompt token ids, and after each generated sequence
                 its ids (a ``# ids:`` line on stdout)
  CALM_POSO=N    offset positions by N (late-context decode profiling)
  CALM_CPU=1     run on the CPU (plain PyTorch path); the GPU otherwise
  CALM_PRECISE=1 as --precise: the prefill's products past 64 rows in
                 f32 instead of bf16, decode per op (the card's 2-64-row
                 matvecs: x in two f16 terms, f32 sums)

-x prints ``# perplexity: P ± E``; -y chats (-n bounds each reply, -1
leaves it unbounded). ``-t > 0`` samples on the device;
``--reference-sampling`` samples on the host with the reference's
xorshift64* stream instead, bit for bit as ``calm_tpu.cli``'s flag. -r N
resets and generates N times, a perf line each (on the card the later
sequences replay the steps the first one captured: their lines are the
steady state). ``--draft d.calm`` decodes speculatively with that draft
model, ``--gamma`` tokens drafted a round (``speculative.
speculative_generate``: greedy at -t 0, rejection sampling above), and
prints the draft's banner and ``# speculative: acceptance A over R rounds
(gamma G)`` on stderr. The draft Engine is made as ``calm_tpu.cli`` makes
it, without ``precise``: so under ``--precise --draft`` it switches the
process-wide quality mode off again, as JAX's does.

    python -m calm_tpu_torch.cli model.calm -t 0 -n 64 -i "..."
    python -m calm_tpu_torch.cli model.calm --draft small.calm --gamma 4 -t 0 -i "..."
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from calm_tpu_torch.container import ContainerError
from calm_tpu_torch.device import NoGPUError
from calm_tpu_torch.engine import Engine, chat_loop


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="calm_tpu_torch", description="quantized LLM inference on Hopper")
    ap.add_argument("checkpoint", help=".calm safetensors model file")
    ap.add_argument("-t", dest="temperature", type=float, default=1.0,
                    help="temperature in [0,inf], default 1.0 (0 = greedy)")
    ap.add_argument("-p", dest="minp", type=float, default=0.1,
                    help="min-p cutoff in [0,1], default 0.1")
    ap.add_argument("-s", dest="seed", type=int, default=0,
                    help="random seed, default time-based")
    ap.add_argument("-n", dest="steps", type=int, default=256,
                    help="steps to run, 0 = max_seq_len, -1 = infinite")
    ap.add_argument("-r", dest="sequences", type=int, default=1,
                    help="number of sequences to decode")
    ap.add_argument("-c", dest="context", type=int, default=0,
                    help="context length override")
    ap.add_argument("-i", dest="prompt", type=str, default=None,
                    help="input prompt (- to read stdin)")
    ap.add_argument("-x", dest="perplexity", type=str, default=None,
                    help="compute perplexity for a text file")
    ap.add_argument("-y", dest="system", type=str, default=None,
                    help="chat mode with this system prompt")
    ap.add_argument("--kv", dest="kv", type=str, default=None,
                    choices=["bf16", "fp16", "fp8"], help="KV cache dtype")
    ap.add_argument("--precise", action="store_true",
                    help="f32 products past 64 rows (2-64 rows: x in two f16 terms, "
                    "f32 sums); also CALM_PRECISE=1")
    ap.add_argument("--reference-sampling", action="store_true",
                    help="per-token host sampling with the reference's "
                    "xorshift64* stream (default: on the device)")
    ap.add_argument("--draft", type=str, default=None,
                    help="draft model (.calm) for speculative decoding (at -t 0 "
                    "the output of -t 0, faster)")
    ap.add_argument("--gamma", type=int, default=4,
                    help="speculation depth (tokens drafted a round)")
    args = ap.parse_args(argv)

    seed = args.seed if args.seed > 0 else int(time.time())
    prompt = args.prompt
    if prompt == "-":
        prompt = sys.stdin.read()

    device = "cpu" if os.environ.get("CALM_CPU", "0") == "1" else "cuda"
    try:
        precise = args.precise or os.environ.get("CALM_PRECISE", "0") == "1"
        engine = Engine(args.checkpoint, context=args.context,
                        kv_dtype=args.kv, device=device, precise=precise)
    except (FileNotFoundError, IsADirectoryError) as e:
        print(f"failed to open {args.checkpoint}: {e}", file=sys.stderr)
        raise SystemExit(1)
    except ContainerError as e:
        print(f"failed to load {args.checkpoint}: {e}", file=sys.stderr)
        raise SystemExit(1)
    except (NoGPUError, NotImplementedError) as e:
        print(f"cannot run {args.checkpoint}: {e}", file=sys.stderr)
        raise SystemExit(1)
    print(engine.banner())
    if engine.device.type == "cuda":
        import torch
        print(f"# device: {torch.cuda.get_device_name(engine.device)} "
              f"x{torch.cuda.device_count()} (cuda)")
    else:
        print("# device: cpu")

    pos_offset = int(os.environ.get("CALM_POSO", "0"))
    steps = args.steps if args.steps != 0 else engine.cfg.seq_len

    if os.environ.get("CALM_TOKENS", "0") == "1" and prompt:
        toks = engine.tokenizer.encode(prompt, bos=True)
        print("".join(f"[{engine.tokenizer.decode([t])}:{t}]" for t in toks))

    # warmup step: builds the kernels (src/run.c:612)
    engine.step(0, pos_offset)
    engine.reset()

    if args.perplexity:
        with open(args.perplexity, "r", errors="replace") as f:
            text = f.read(64 * 1024)
        t0 = time.perf_counter()
        ppl, err, n = engine.perplexity(text, steps,
                                        progress=lambda s: print(s, flush=True))
        dt = time.perf_counter() - t0
        print(f"# perplexity: {ppl:.3f} ± {err:.3f} "
              f"({dt:.2f} sec, {n / dt:.2f} tok/s)")
    elif args.system is not None:
        chat_loop(engine, args.system, prompt, temperature=args.temperature,
                  minp=args.minp, seed=seed,
                  reference_sampling=args.reference_sampling,
                  max_reply=steps if steps > 0 else None)
    elif args.draft:
        from calm_tpu_torch.speculative import speculative_generate
        try:  # no precise=: as calm_tpu/cli.py:119, it turns the mode off
            draft = Engine(args.draft, context=args.context, kv_dtype=args.kv,
                           device=device)
        except (FileNotFoundError, IsADirectoryError, ContainerError,
                NotImplementedError) as e:
            print(f"failed to load draft {args.draft}: {e}", file=sys.stderr)
            raise SystemExit(1)
        print(draft.banner())
        for _ in range(args.sequences):
            engine.reset()
            draft.reset()
            stats = speculative_generate(
                engine, draft, prompt or "", steps, gamma=args.gamma,
                temperature=args.temperature, minp=args.minp, seed=seed,
                pos_offset=pos_offset, echo=True,
                on_piece=lambda s: print(s, end="", flush=True))
            print()
            print(stats.perf_line(), file=sys.stderr)
            print(f"# speculative: acceptance {stats.acceptance:.2f} over "
                  f"{stats.rounds} rounds (gamma {args.gamma})", file=sys.stderr)
    else:
        for _ in range(args.sequences):
            engine.reset()
            stats = engine.generate(
                prompt or "", steps, temperature=args.temperature, minp=args.minp,
                seed=seed, pos_offset=pos_offset, echo=True,
                reference_sampling=args.reference_sampling,
                on_piece=lambda s: print(s, end="", flush=True))
            print()
            if os.environ.get("CALM_TOKENS", "0") == "1":
                print("# ids: " + " ".join(str(t) for t in stats.ids))
            print(stats.perf_line(), file=sys.stderr)


if __name__ == "__main__":
    main()
