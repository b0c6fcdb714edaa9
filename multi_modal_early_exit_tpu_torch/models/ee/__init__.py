"""Early-exit heads, batched EE forward, and the anytime cascade."""
