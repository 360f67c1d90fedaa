"""Hand-written Hopper kernels of the port (CUDA C++ in ``../csrc``).

``ops`` = public wrappers, ``ref`` = pure-torch oracles, one module per
kernel with its plain torch version beside it. ``_backend`` picks kernel or
plain version per call; ``_build`` compiles ``csrc/*.cu`` for sm_90a on
first use. Nothing is compiled at import time.
"""
from . import flash_attention, gossip_mix, ops, quantize, ref, rglru_scan
from . import rwkv6_scan

__all__ = ["ops", "ref", "counted_wrappers"]


def counted_wrappers() -> tuple:
    """Every kernel wrapper that counts its launches in ``.launches``."""
    return (gossip_mix.gossip_mix_rows, gossip_mix.gossip_mix_q8_rows,
            quantize.quantize_int8, quantize.dequantize_int8,
            flash_attention.flash_attention, rglru_scan.rglru_scan,
            rwkv6_scan.rwkv6_scan)
