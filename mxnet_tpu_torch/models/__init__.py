"""Model entry points of the port (this slice: the transformer LM's
decode step)."""
from . import transformer

__all__ = ["transformer"]
