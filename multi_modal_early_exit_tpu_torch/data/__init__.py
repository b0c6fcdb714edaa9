"""Host feature conversion, labels and device image preprocessing."""
