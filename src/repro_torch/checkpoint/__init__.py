"""Checkpoints of the port (``checkpoint/checkpoint.py``), in the
reference's on-disk format."""
