"""Optimizers: AdamW (``adamw.py``)."""
