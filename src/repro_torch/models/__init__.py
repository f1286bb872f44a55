"""LM substrate: the model, caches, layers and blocks of every family."""
from .model import Model
