"""Models of the port. This slice carries the paper's CNN; the model zoo
comes in a later slice."""
from . import cnn

__all__ = ["cnn"]
