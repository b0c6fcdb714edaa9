"""Exit-criterion functions on raw logits, computed in float32.

The entropy is taken in the max-shifted form, which is the Shannon entropy
of softmax(x) and safe from overflow in bf16 and f32:

    H(x) = log(sum exp(x)) - sum(x * exp(x)) / sum(exp(x))
"""

from __future__ import annotations

import torch


def entropy(x: torch.Tensor) -> torch.Tensor:
    """Predictive entropy of softmax(x) along the last axis. Lower ⇒ exit."""
    x = x.to(torch.float32)
    x = x - x.amax(dim=-1, keepdim=True)
    exp_x = torch.exp(x)
    a = exp_x.sum(dim=-1)
    b = (x * exp_x).sum(dim=-1)
    return torch.log(a) - b / a


def max_confidence(x: torch.Tensor) -> torch.Tensor:
    """Maximum softmax probability along the last axis. Higher ⇒ exit."""
    return torch.softmax(x.to(torch.float32), dim=-1).amax(dim=-1)


def lte(x: torch.Tensor) -> torch.Tensor:
    """Learning-to-exit: the LTE head's sigmoid output is the criterion."""
    return x


def patience_counts(logit_store: torch.Tensor) -> torch.Tensor:
    """PABEE patience counts over an (E, B, K) per-exit logit store.

    Returns (E, B) f32 counts: ``counts[0] = 0``; ``counts[j] =
    counts[j-1] + 1`` if the top-1 prediction at exit j equals exit j-1's,
    else 0. A sample exits when its count reaches the patience threshold.
    """
    preds = logit_store.to(torch.float32).argmax(dim=-1)  # (E, B)
    counts = [torch.zeros(preds.shape[1:], dtype=torch.float32,
                          device=preds.device)]
    for j in range(1, preds.shape[0]):
        same = preds[j] == preds[j - 1]
        counts.append(torch.where(same, counts[-1] + 1.0, 0.0))
    return torch.stack(counts)
