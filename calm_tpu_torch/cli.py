"""Command-line entry point: generate (the port of ``calm_tpu.cli``).

Flag-compatible with the reference CLI (src/run.c:421-490):
  -t temperature   -p min-p   -s seed   -n steps   -c context
  -i prompt (- reads stdin)   --kv KV cache dtype

Env hooks:
  CALM_TOKENS=1  dump prompt token ids
  CALM_POSO=N    offset positions by N (late-context decode profiling)
  CALM_CPU=1     run on the CPU (plain PyTorch path); the GPU otherwise

-x (perplexity), -y (chat), -r (several sequences) and --draft are not
ported yet and exit with a message saying so.

    python -m calm_tpu_torch.cli model.calm -t 0 -n 64 -i "..."
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from calm_tpu_torch.container import ContainerError
from calm_tpu_torch.device import NoGPUError
from calm_tpu_torch.engine import Engine

_NOT_PORTED = {"perplexity": "-x", "system": "-y", "sequences": "-r",
               "draft": "--draft"}


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
    ap.add_argument("-c", dest="context", type=int, default=0,
                    help="context length override")
    ap.add_argument("-i", dest="prompt", type=str, default=None,
                    help="input prompt (- to read stdin)")
    ap.add_argument("--kv", dest="kv", type=str, default=None,
                    choices=["bf16", "fp16", "fp8"], help="KV cache dtype")
    ap.add_argument("-x", dest="perplexity", default=None, help=argparse.SUPPRESS)
    ap.add_argument("-y", dest="system", default=None, help=argparse.SUPPRESS)
    ap.add_argument("-r", dest="sequences", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--draft", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    for dest, flag in _NOT_PORTED.items():
        if getattr(args, dest) is not None:
            print(f"{flag} is not yet ported to calm_tpu_torch; use "
                  "python -m calm_tpu.cli for it", file=sys.stderr)
            raise SystemExit(2)

    seed = args.seed if args.seed > 0 else int(time.time())
    prompt = args.prompt
    if prompt == "-":
        prompt = sys.stdin.read()

    device = "cpu" if os.environ.get("CALM_CPU", "0") == "1" else "cuda"
    try:
        engine = Engine(args.checkpoint, context=args.context,
                        kv_dtype=args.kv, device=device)
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

    stats = engine.generate(
        prompt or "", steps, temperature=args.temperature, minp=args.minp,
        seed=seed, pos_offset=pos_offset, echo=True,
        on_piece=lambda s: print(s, end="", flush=True))
    print()
    print(stats.perf_line(), file=sys.stderr)


if __name__ == "__main__":
    main()
