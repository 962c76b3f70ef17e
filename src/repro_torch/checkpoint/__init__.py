"""Checkpoints in the reference's npz format (``ckpt``)."""
