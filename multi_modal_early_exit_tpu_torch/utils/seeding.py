"""Reproducibility helpers (reference: EE/configs.py:209-216).

The port's counterpart of the JAX package's ``utils/seeding.py``: it seeds
python, numpy and torch, and returns the CPU ``torch.Generator`` from which
``EETrainer.train_step`` draws its dropout seeds (the JAX package returns
its root PRNG key).
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int) -> torch.Generator:
    """Seed the host RNGs and torch's; return a CPU generator seeded with
    ``seed``."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
