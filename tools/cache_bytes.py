#!/usr/bin/env python3
"""Per-rank bytes of each served arch's serving cache over a 'model' axis:
the port's layout (``train.shardings.cache_layout``) against the JAX
package's reckoning (``train.shardings.cache_specs``, the reference's
rules ported entry for entry), from shapes alone (fake tensors: nothing
is allocated), on the CPU.

Run from the repository root:
    python3 tools/cache_bytes.py [--tp 4] [--batch 4] [--len 4128]
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCHS = ("phi3.5-moe-42b-a6.6b", "recurrentgemma-2b", "rwkv6-7b",
         "deepseek-v2-lite-16b", "seamless-m4t-large-v2", "qwen2-vl-2b")


def per_rank(arch: str, tp: int, batch: int, length: int) -> dict:
    """{"whole", "port", "jax"}: bytes of the whole cache, of the port's
    rank shard (rank 0; every rank's is the same size), and of a rank's
    shard under ``cache_specs`` (the batch unsplit: one data rank)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.core.dpsgd import _leaves
    from repro_torch.models import encdec, tp as t_tp, transformer
    from repro_torch.train import shardings as shr

    cfg = get_config(arch)
    model = t_tp.Model(None, tp, 0)
    with FakeTensorMode():
        if cfg.is_encdec:
            whole = encdec.init_dec_cache(cfg, batch, length // 2,
                                          length // 2, device="cpu")
        else:
            whole = transformer.init_cache(cfg, batch, length, device="cpu")
        port = shr.shard_caches(whole, cfg, model)
        specs = shr.spec_leaves(shr.cache_specs(whole, tp, ("data",),
                                                batch, 1))
        jax = sum(math.prod(d // tp if e == "model" else d
                            for d, e in zip(x.shape, tuple(sp)))
                  * x.element_size() for x, sp in zip(_leaves(whole), specs))

        def nbytes(tree):
            return sum(x.numel() * x.element_size() for x in _leaves(tree))
        return {"whole": nbytes(whole), "port": nbytes(port), "jax": jax}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--len", type=int, default=4128,
                    help="cache positions (an encoder-decoder's: half "
                         "self attention, half cross)")
    args = ap.parse_args()
    print(f"serving cache bytes a rank at tp {args.tp}, batch {args.batch}, "
          f"{args.len} positions (GiB): whole, the port's layout, "
          f"cache_specs")
    for arch in ARCHS:
        r = per_rank(arch, args.tp, args.batch, args.len)
        print(f"{arch:24s} {r['whole'] / 2**30:9.4f} {r['port'] / 2**30:9.4f} "
              f"{r['jax'] / 2**30:9.4f}")


if __name__ == "__main__":
    main()
