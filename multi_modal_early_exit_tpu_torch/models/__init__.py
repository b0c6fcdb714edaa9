"""Model definitions: the LayoutLMv3 backbone and the early-exit model."""
