"""Models of the port: the paper's CNN and the model zoo (layer kinds
global, local, rglru, rwkv and mla, MoE MLPs, and the encoder-decoder)
behind the ``api`` facade."""
from . import (api, attention, cnn, encdec, layers, mla, moe, rglru, rwkv6,
               transformer)
from .api import ModelAPI, build

__all__ = ["api", "attention", "cnn", "encdec", "layers", "mla", "moe",
           "rglru", "rwkv6", "transformer", "ModelAPI", "build"]
