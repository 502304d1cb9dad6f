"""Optimizers of the training path: AdamW on dicts of tensors
(:mod:`.adamw`)."""
