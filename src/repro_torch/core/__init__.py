"""Core of the paper's contribution: network-density-controlled D-PSGD.

channel (Eq. 2), topology (Eq. 4), bound (Eq. 6/7), rate_opt (Eq. 8 /
Algorithm 2) and comm_model (Eq. 3) are numpy, copied from the JAX package;
compression (int8 / bf16 payloads) and dpsgd (Algorithm 1 / Eq. 5) are
torch, with the gossip mix on the hand-written kernels.
"""
from . import bound, channel, comm_model, compression, dpsgd, rate_opt, topology

__all__ = ["bound", "channel", "comm_model", "compression", "dpsgd",
           "rate_opt", "topology"]
