"""Discrete-event wireless network simulator (time-domain layer over the
paper's static model).

The repo's original evaluation freezes the channel: one capacity matrix,
one Algorithm 2 solve, Eq. 3 arithmetic for communication time. This
package adds the time axis — per-slot fading realizations, packet-level TDM
with outage/retransmission, node mobility and Poisson churn, and drift-
triggered re-planning — while keeping the static scenario numerically
identical to the Eq. 3 model (the regression anchor for
``benchmarks/fig3_runtime.py``).

Modules:

* ``events``   — deterministic event queue + simulated clock
* ``fading``   — Rayleigh/shadowing ``C_ij(t)`` over ``core.channel``
* ``faults``   — deterministic fault injection: Gilbert-Elliott link
  blackouts, correlated crash/recover, stragglers, stale planner inputs
  (the ``fault_*`` scenarios; recovery loop lives in ``runtime.fault``)
* ``mac``      — packet-level TDM broadcast, outage, retransmission
* ``mac_ra``   — slotted random-access broadcast: contention, collisions,
  SINR capture, slots-until-coverage airtime (planned by
  ``core.access_opt``)
* ``mobility`` — waypoint/cluster motion + Poisson churn
* ``policy``   — scheduling-policy plane: per-round transmitter set, rates,
  slot plan (``TDMPolicy`` / ``UniformRAPolicy`` adapters + BASS-style
  sampled collision-free broadcast groups planned by ``core.sched_opt``)
* ``scenario`` — named scenario registry (static/fading/mobile/churn/mixed
  + the ``ra_*`` random-access and ``bass_*`` subgraph-sampling families)
* ``trace``    — event loop, per-round traces, accuracy-vs-simulated-time,
  driver-less ``precompute_trace`` (fixed-shape channel realizations)

The torch counterpart of ``repro.sim``: every module above is numpy copied
verbatim, and ``trace.simulate_dpsgd_cnn`` trains on the port's D-PSGD
steps. Train-on-trace (``sim/batch.py``) and the jitted scan engine are
not ported yet (ROADMAP Queue 1), so their names are not exported.
"""
from ..core.compression import QuantConfig
from .events import Event, EventKind, EventQueue, SimClock
from .fading import FadingChannel, FadingParams
from .faults import FaultParams, FaultSchedule, RoundFaults
from .mac import (DEGRADE_MODES, MacParams, RoundResult, mean_drift,
                  tdm_round, tdm_round_reference)
from .mac_ra import RAParams, ra_round
from .mobility import (ClusterMobility, PoissonChurn, RandomWaypoint,
                       StaticMobility, make_mobility)
from .policy import (BASSParams, BASSPolicy, EnergyBASSPolicy, PolicyRound,
                     SchedulingPolicy, TDMPolicy, UniformRAPolicy,
                     bass_round, make_policy)
from .scenario import (DEFAULT_MODEL_BITS, MAC_KINDS, POLICY_KINDS,
                       ScenarioConfig, get_scenario, list_scenarios, register)
from .trace import (RoundContext, RoundRecord, SimTrace, TraceBatch,
                    TrainTrace, WirelessSimulator, precompute_trace,
                    precompute_traces, simulate_dpsgd_cnn, stack_traces,
                    sweep)

__all__ = [
    "QuantConfig",
    "Event", "EventKind", "EventQueue", "SimClock",
    "FadingChannel", "FadingParams",
    "FaultParams", "FaultSchedule", "RoundFaults",
    "DEGRADE_MODES", "MacParams", "RoundResult", "mean_drift", "tdm_round",
    "tdm_round_reference",
    "RAParams", "ra_round",
    "ClusterMobility", "PoissonChurn", "RandomWaypoint", "StaticMobility",
    "make_mobility",
    "BASSParams", "BASSPolicy", "EnergyBASSPolicy", "PolicyRound",
    "SchedulingPolicy", "TDMPolicy", "UniformRAPolicy", "bass_round",
    "make_policy",
    "DEFAULT_MODEL_BITS", "MAC_KINDS", "POLICY_KINDS", "ScenarioConfig",
    "get_scenario", "list_scenarios", "register",
    "RoundContext", "RoundRecord", "SimTrace", "TraceBatch", "TrainTrace",
    "WirelessSimulator", "precompute_trace", "precompute_traces",
    "simulate_dpsgd_cnn", "stack_traces", "sweep",
]
