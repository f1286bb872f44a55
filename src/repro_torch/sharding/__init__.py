"""Logical-axis sharding rules (``rules.py``)."""
