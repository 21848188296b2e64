"""Checkpoints of trees of tensors (``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpoint import latest_step, restore, save
