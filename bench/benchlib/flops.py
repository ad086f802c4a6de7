"""Model FLOPs of the work a window completed, from its requests alone
(each at its own positions, by ``work.model_flops``): a prompt's when its
prefill ends inside the window, a decoded token's when it comes inside."""
from __future__ import annotations

from . import work


def prefill(run) -> float:
    w = run.window
    return sum(work.model_flops(run.model, len(r.prompt), 0, 1)
               for r in w.records
               if r.token_times and w.t_open <= r.token_times[0] < w.t_close)


def decode(run) -> float:
    w = run.window
    total = 0.0
    for r in w.records:
        n = len(r.prompt)
        for i, t in enumerate(r.token_times[1:], start=1):
            if w.t_open <= t < w.t_close:
                total += work.model_flops(run.model, 1, n + i - 1, 1)
    return total
