"""Data: datasets (synthetic and hub-backed), OCR ingestion, host feature
conversion, labels, device image preprocessing and batch loading."""
