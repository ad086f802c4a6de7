"""Whether what the timed path served is right: a sample of the requests
the window finished, drawn from the seed with the longest among them, is
run through the plain reference over each prompt and its served tokens,
and each served token's logit is compared with the reference's best at
its position.  The numbers compared are the widest and the mean such gap
(logit units).  The reference reads nothing of how the program batched or
cached the request: only the prompt and the tokens served.
"""
from __future__ import annotations

import numpy as np
import torch


def sample(records, seed: int, min_tokens: int, max_requests: int) -> list:
    """Finished requests: the longest (prompt and served tokens), then
    others in the seed's order until ``min_tokens`` served tokens or
    ``max_requests`` requests."""
    done = [r for r in records if r.ok]
    if not done:
        return []
    done.sort(key=lambda r: r.req.rid)
    longest = max(done, key=lambda r: (len(r.prompt) + len(r.tokens),
                                       -r.req.rid))
    out = [longest]
    served = len(longest.tokens)
    order = np.random.default_rng([int(seed) & (2 ** 64 - 1), 7]) \
        .permutation(len(done))
    for i in order:
        if served >= min_tokens or len(out) >= max_requests:
            break
        r = done[i]
        if r is longest:
            continue
        out.append(r)
        served += len(r.tokens)
    return out


def sequence(rec, device):
    """The prompt and the served tokens but the last, and the row of the
    prompt's last position (whose logits gave the first served token)."""
    toks = np.concatenate([rec.prompt.astype(np.int64),
                           np.asarray(rec.tokens[:-1], np.int64)])
    return torch.as_tensor(toks, device=device), len(rec.prompt) - 1


@torch.no_grad()
def gaps(ref, model_cfg: dict, weights: dict, recs, quant=None) -> list:
    """Per request, per served position: (reference best - reference logit
    of the token chosen).  The token chosen is the one served, or with
    ``quant`` the one the reference computed at that precision puts
    first (the control)."""
    out = []
    for rec in recs:
        toks, first = sequence(rec, weights["embed"]["table"].device)
        lg = ref.logits(model_cfg, weights, toks, first)
        if quant is None:
            chosen = torch.as_tensor(rec.tokens, device=lg.device)
        else:
            chosen = ref.logits(model_cfg, weights, toks, first,
                                quant=quant).argmax(-1)
        best = lg.max(-1).values
        out.append((best - lg.gather(-1, chosen[:, None].long())[:, 0])
                   .cpu().tolist())
    return out


def numbers(per_request: list) -> dict:
    """The numbers a check can compare, over every served position of the
    sample: the widest gap, the mean gap, and the share of positions whose
    token is not the reference's best."""
    flat = [g for per in per_request for g in per]
    if not flat:
        return {}
    return {"max_logit_gap": max(flat),
            "mean_logit_gap": sum(flat) / len(flat),
            "not_best_share": sum(g > 0 for g in flat) / len(flat)}
