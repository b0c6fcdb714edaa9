"""Training: the EE losses, per-exit subgraph accounting and the trainer."""
