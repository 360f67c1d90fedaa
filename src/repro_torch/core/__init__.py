"""Core of the paper's contribution: network-density-controlled D-PSGD.

channel (Eq. 2), topology (Eq. 4), bound (Eq. 6/7), rate_opt (Eq. 8 /
Algorithm 2), comm_model (Eq. 3), access_opt (the Algorithm-2 analogue for
the random-access MAC), sched_opt (the BASS scheduling planner),
density_controller (Eq. 8 on mesh link models) and the plan half of gossip
are numpy, copied from the JAX package; compression (int8 / bf16 payloads)
and dpsgd (Algorithm 1 / Eq. 5) are torch, with the gossip mix and the int8
codec on the hand-written kernels.
"""
from . import (access_opt, bound, channel, comm_model, compression,
               density_controller, dpsgd, gossip, rate_opt, sched_opt,
               topology)

__all__ = ["access_opt", "bound", "channel", "comm_model", "compression",
           "density_controller", "dpsgd", "gossip", "rate_opt", "sched_opt",
           "topology"]
