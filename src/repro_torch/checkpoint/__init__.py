"""Checkpoints of the port (``checkpoint.py``)."""
