"""Hand-written Hopper kernels of the port (CUDA C++ in ``../csrc``).

``ops`` = public wrappers, ``ref`` = pure-torch oracles, one module per
kernel with its plain torch version beside it. ``_backend`` picks kernel or
plain version per call; ``_build`` compiles ``csrc/*.cu`` for sm_90a on
first use. Nothing is compiled at import time.
"""
from . import ops, ref

__all__ = ["ops", "ref"]
