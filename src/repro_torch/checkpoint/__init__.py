from .ckpt import compact_nodes, expand_nodes, reshape_nodes

__all__ = ["reshape_nodes", "compact_nodes", "expand_nodes"]
