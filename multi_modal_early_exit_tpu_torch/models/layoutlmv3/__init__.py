"""LayoutLMv3: config, parameter modules, forward path, weight bridge."""
