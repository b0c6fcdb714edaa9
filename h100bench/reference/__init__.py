"""The plain reference: EE LayoutLMv3 in plain PyTorch, in float32 with TF32
off, written from the published model (HF ``LayoutLMv3Model``) and the
early-exit semantics the configuration states. It imports nothing of the
program; what it shares with it are the inputs, the weights and the dropout
seeds, which the harness hands to both sides."""
