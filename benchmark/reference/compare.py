"""What decides ``correct``: the served tokens against the reference.

For each sampled request, the reference runs once over its prompt and
the tokens the program served. At the position before each served token
the gap is the reference's best logit less the served token's logit: 0
where the program picked the reference's argmax, small where rounding
flipped a near-tie, large where the program computed something else.
Two numbers are read from the gaps of every sampled token: the widest
(``max_logit_gap``) and their mean (``mean_logit_gap``); a cell's file
says which of them it compares and against what limit.

A control (:func:`control_stats`) is the reference itself in a lower
precision (``reference.model``: the KV cache at fp8 e5m2, or the weights
at 4 bits), read teacher-forced at the same positions: the same numbers
for the token that it puts first.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark import weights as W
from benchmark.reference.model import logits_at


@dataclasses.dataclass
class Served:
    """One finished request: its prompt as the benchmark tokenizes it and
    the ids the program served after it."""

    prompt: list[int]
    served: list[int]


def _rows(s: Served) -> list[int]:
    n = len(s.prompt)
    return list(range(n - 1, n - 1 + len(s.served)))


def _seqs(sample: list[Served]) -> list[list[int]]:
    # the last served token is predicted, never fed
    return [s.prompt + s.served[:-1] for s in sample]


def _gaps(ref: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return ref.max(-1).values - ref.gather(1, ids[:, None])[:, 0]


def stats(gaps: list[torch.Tensor]) -> dict:
    g = torch.cat(gaps)
    return {"max_logit_gap": float(g.max()), "mean_logit_gap": float(g.mean()),
            "tokens": int(g.numel())}


def served(d: W.Dims, seed: int, sample: list[Served], device):
    """(the gaps' numbers, the reference's logits)."""
    ref = logits_at(d, seed, _seqs(sample), [_rows(s) for s in sample], device)
    gaps = [_gaps(lg, torch.tensor(s.served, device=lg.device)) for lg, s in zip(ref, sample)]
    return stats(gaps), ref


def control_stats(d: W.Dims, seed: int, sample: list[Served], device, ref,
                  control: str) -> dict:
    """The numbers of ``control``'s first choice, against ``ref`` (the
    reference's logits from :func:`served`)."""
    low = logits_at(d, seed, _seqs(sample), [_rows(s) for s in sample], device,
                    control=control)
    return stats([_gaps(lg, lo.argmax(-1)) for lg, lo in zip(ref, low)])
