"""Atomic, async checkpoints in the reference's on-disk format."""
