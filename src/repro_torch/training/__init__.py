"""Training (reference ``repro/training``): AdamW, the train step and
checkpoints."""
