"""Fault tolerance (``fault.py``) and restore onto a device (``elastic.py``)."""
