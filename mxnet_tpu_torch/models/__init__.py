"""Model entry points of the port (so far the transformer LM: its
training graph and its decode step)."""
from . import transformer

__all__ = ["transformer"]
