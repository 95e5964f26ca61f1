"""Checkpoints on the reference's on-disk layout (``repro.checkpoint``)."""
