from .ckpt import (CheckpointManager, compact_nodes, expand_nodes,
                   latest_step, reshape_nodes, restore, save)

__all__ = ["CheckpointManager", "save", "latest_step", "restore",
           "reshape_nodes", "compact_nodes", "expand_nodes"]
