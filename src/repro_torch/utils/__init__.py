"""Tree utilities of the port (``tree``: flat buffers of a parameter tree)."""
from . import tree

__all__ = ["tree"]
