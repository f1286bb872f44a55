"""Checkpointing of the train state (``ckpt.py``)."""
