"""Models of the port: the paper's CNN and the decoder-only model zoo
(layer kinds global, local, rglru and rwkv) behind the ``api`` facade."""
from . import api, attention, cnn, layers, rglru, rwkv6, transformer
from .api import ModelAPI, build

__all__ = ["api", "attention", "cnn", "layers", "rglru", "rwkv6",
           "transformer", "ModelAPI", "build"]
