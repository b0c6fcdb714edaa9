"""Host utilities: logging, running meters and the artifact files (npz logit
stores, JSON results) shared with the JAX package."""
