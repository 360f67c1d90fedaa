"""Pod-mode training on one device: Mode A / Mode B step builders."""
from . import step
from .step import init_train_state, make_train_step, reshape_batch_for_nodes

__all__ = ["step", "init_train_state", "make_train_step",
           "reshape_batch_for_nodes"]
