"""Synthetic graph workloads (``graphs``)."""
