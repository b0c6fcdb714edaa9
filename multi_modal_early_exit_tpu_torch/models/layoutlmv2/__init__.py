"""LayoutLMv2: the ResNeXt-FPN visual tower, the v2 embeddings, the dense classifier."""
