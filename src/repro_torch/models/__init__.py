"""LM substrate: the dense architectures' model, caches and layers."""
from .model import Model
