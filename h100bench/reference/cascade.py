"""The capacity-constrained cascade's decisions, from per-exit criteria.

Every document passes its embedding exits; each encoder stage then runs at
most ``capacity`` of the documents still running, chosen as the least
exit-worthy by their last criterion (ties: the lower row first). A document
that wants to go on but finds no room leaves at once at its last evaluated
exit ("capacity-exited"); the final classifier takes everyone left.
Capacities follow the binomial tail of the exit distribution, rounded up to
a multiple of 8 and capped at the batch.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import torch


def capacities(dist: dict, batch: int, n_emb: int, n_stages: int, tail: float,
               multiple: int = 8) -> tuple:
    """Per-stage capacities: the ``tail`` quantile of the number of
    documents that reach the stage, under the normal approximation of the
    binomial, p * B + z sqrt(B p (1 - p))."""
    z = NormalDist().inv_cdf(tail)
    reach = 1.0 - sum(dist.get(j, 0.0) for j in range(n_emb))
    caps = []
    for s in range(n_stages):
        p = min(max(reach, 0.0), 1.0)
        want = p * batch + z * math.sqrt(batch * p * (1.0 - p))
        caps.append(max(min(batch, math.ceil(want / multiple) * multiple), multiple))
        reach -= dist.get(n_emb + s, 0.0)
    return tuple(caps)


def decide(crit: torch.Tensor, thresholds, caps, n_emb: int):
    """(exit index per row, capacity-exited per row) from ``crit`` (E + 1,
    B) maximum-softmax criteria (higher leaves), ``thresholds`` (E,).
    Encoder stage s ends at exit n_emb + s; the last stage at the
    classifier, index E."""
    crit = crit.detach().float().cpu()
    e_count, b = crit.shape[0] - 1, crit.shape[1]
    exit_ids = [e_count] * b
    forced = [False] * b
    running = [True] * b
    last = [0.0] * b
    for j in range(n_emb):
        for r in range(b):
            if running[r]:
                last[r] = float(crit[j, r])
                if last[r] > thresholds[j]:
                    exit_ids[r], running[r] = j, False
    for s, cap in enumerate(caps):
        order = sorted((r for r in range(b) if running[r]), key=lambda r: (last[r], r))
        for r in order[cap:]:
            exit_ids[r] = n_emb - 1 if s == 0 else n_emb + s - 1
            forced[r], running[r] = True, False
        final = s == len(caps) - 1
        j = e_count if final else n_emb + s
        for r in order[:cap]:
            last[r] = float(crit[j, r])
            if final or last[r] > thresholds[j]:
                exit_ids[r], running[r] = j, False
    return exit_ids, forced
