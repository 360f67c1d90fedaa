from .synthetic import (SyntheticFashion, node_splits, synthetic_images,
                        token_stream)
from .pipeline import ShardedLoader

__all__ = ["SyntheticFashion", "node_splits", "synthetic_images",
           "token_stream", "ShardedLoader"]
