"""Named simulation scenarios: dataclass configs + registry.

A scenario bundles every knob of the discrete-event simulator — channel
constants, fading process, mobility model, churn rate, MAC, replan policy —
under one name so benchmarks, examples, and tests all speak the same
vocabulary:

* ``static``  — the paper's setup verbatim: frozen placement, no fading, no
  churn. This is the regression anchor: its simulated round time equals
  Eq. 3's ``tdm_time_s`` to float64 rounding.
* ``fading``  — Rayleigh block fading + correlated shadowing on the static
  placement; the plan's ``fading_margin_bps`` becomes a real
  outage-vs-goodput dial.
* ``mobile``  — random-waypoint motion with drift-triggered re-runs of
  Algorithm 2 (`rate_opt.solve`) as the capacity matrix wanders.
* ``churn``   — Poisson node failures feeding
  ``runtime.fault.ElasticController`` (survivor replan + elastic reshape).
* ``mixed``   — cluster mobility + fading + churn + periodic replan, all at
  once; the stress case.
* ``ra_static`` / ``ra_fading`` / ``ra_capture`` — the same worlds under the
  **random-access broadcast MAC** (``mac_kind="random_access"``): slotted
  contention instead of a TDM schedule, ``core.access_opt`` choosing
  ``(p_i, R_i)`` instead of Algorithm 2's rates alone, and a mixing graph
  that is random per round (collision-sampled subgraphs). ``ra_capture``
  adds an SINR capture threshold, so the strongest of colliding signals can
  still get through.
* ``compressed_bf16`` / ``compressed_int8`` / ``compressed_ra`` — the
  ``fading`` (respectively ``ra_fading``) world with a compressed gossip
  payload (``payload: QuantConfig``): Eq. 3 / the RA slot clock charge the
  **exact wire bits** of the compressed message, and train-on-trace mixes
  quantized messages with per-node error feedback
  (``core.dpsgd.dpsgd_masked_compressed_step``).

* ``bass_static`` / ``bass_fading`` / ``bass_energy`` — the **scheduling-
  policy plane** (``policy="bass"``, ``sim.policy.BASSPolicy``):
  importance-sampled collision-free broadcast subsets each round, planned
  by ``core.sched_opt`` for accuracy per simulated second rather than round
  time under a fixed lambda. ``bass_energy`` additionally duty-cycles every
  node to half the rounds (``BASSParams(duty_cycle=0.5)``).

* ``fault_burst`` / ``fault_crash`` / ``fault_stragglers`` / ``fault_chaos``
  — the **fault-injection plane** (``ScenarioConfig.faults``,
  ``sim.faults.FaultSchedule``): Gilbert–Elliott link blackout bursts,
  correlated node crash/recover (crashed nodes rejoin with stale
  parameters), per-node straggler slowdowns, stale planner inputs, and
  heartbeat-timeout survivor replans with a common-rate fallback plan.
  ``degrade`` picks how ``effective_w`` absorbs lost links ("renorm" |
  "naive") and ``watchdog`` arms the train-scan NaN/divergence guard.

Register custom scenarios with ``register``; fetch-and-override with
``get_scenario(name, **overrides)`` — overrides reach **nested** param
dataclasses via dotted keys (``**{"ra.max_slots": 8}``) or sub-dict merge
(``ra={"max_slots": 8}``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.channel import ChannelParams
from ..core.compression import PAYLOAD_MODES, QuantConfig
from .fading import FadingParams
from .faults import FaultParams
from .mac import DEGRADE_MODES, MacParams
from .mac_ra import RAParams
from .policy import BASSParams, POLICY_KINDS

__all__ = ["ScenarioConfig", "register", "get_scenario", "list_scenarios",
           "DEFAULT_MODEL_BITS", "MAC_KINDS", "POLICY_KINDS",
           "SCENARIO_PAYLOAD_MODES"]

MAC_KINDS = ("tdm", "random_access")

# payload modes a scenario may carry: the concrete QuantConfig modes plus
# "auto" — let the joint planner (rate_opt.solve_joint /
# access_opt.solve_access_joint) pick the mode per replan. "auto" is a
# comm-plane setting only; training needs the concrete mode the plan chose.
SCENARIO_PAYLOAD_MODES = PAYLOAD_MODES + ("auto",)

# paper §IV-A message size: the 21 840-param CNN at float32
# (== models.cnn.MODEL_BITS; cross-checked in tests/test_sim.py — the sim
# core stays jax-free, so no import from models here)
DEFAULT_MODEL_BITS = 21_840 * 32.0


def _prod(shape) -> int:
    out = 1
    for d in shape:
        out *= int(d)
    return out


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Everything a simulator run needs, frozen and hashable."""

    name: str
    # node set / placement (paper §IV: n=6 in a 200 m square)
    n_nodes: int = 6
    area_m: float = 200.0
    seed: int = 0
    min_nodes: int = 3            # churn never shrinks the net below this
    # channel constants (paper Fig. 3 defaults)
    path_loss_exp: float = 5.0
    p_tx_dbm: float = 0.0
    bandwidth_hz: float = 20e6
    noise_floor_dbm: float = -172.0
    fading_margin_bps: float = 0.0
    # workload
    model_bits: float = DEFAULT_MODEL_BITS
    # leaf shapes of the model's parameter pytree (tuple of shape tuples,
    # hashable). Empty = unknown/flat-buffer workload (every pre-pytree
    # config): wire accounting treats model_bits as one message buffer.
    # Set (sim.batch.transformer_adapter does) it lets wire_bits() charge
    # the exact per-leaf framing that payload.granularity="leaf" implies.
    model_shapes: tuple = ()
    # gossip payload compression (core.compression): what actually crosses
    # the air. Eq. 3 / the RA slot clock charge wire_bits(), not model_bits.
    payload: QuantConfig = QuantConfig(mode="none")
    lambda_target: float = 0.3
    compute_s_per_round: float = 0.0   # simulated per-iteration compute time
    # time-varying processes (None / "static" / 0.0 = off)
    fading: Optional[FadingParams] = None
    mobility_kind: str = "static"      # static | waypoint | cluster
    speed_mps: float = 1.5
    pause_s: float = 0.0
    n_clusters: int = 2
    cluster_spread_m: float = 20.0
    churn_rate_per_s: float = 0.0
    # link layer: "tdm" (the paper's collision-free schedule, MacParams) or
    # "random_access" (slotted contention broadcast, RAParams + access_opt)
    mac_kind: str = "tdm"
    mac: MacParams = dataclasses.field(default_factory=MacParams)
    ra: RAParams = dataclasses.field(default_factory=RAParams)
    # scheduling policy (sim.policy): who transmits each round. "auto"
    # derives from mac_kind (tdm -> TDMPolicy, random_access ->
    # UniformRAPolicy) so pre-policy configs behave identically; "bass"
    # activates sampled collision-free broadcast subsets planned by
    # core.sched_opt (lambda_target is non-binding there — the planner
    # optimizes time-to-accuracy, not round time at a pinned density).
    policy: str = "auto"
    bass: BASSParams = dataclasses.field(default_factory=BASSParams)
    reference_mac: bool = False        # pinned per-packet loop MAC (benchmarks)
    # replan policy (Algorithm 2 re-runs)
    solver: str = "auto"               # rate_opt.solve method (auto = exact)
    replan_every_rounds: int = 0       # 0 = never on a schedule
    replan_drift_rel: float = 0.0      # 0 = never on drift
    # evaluation cadence for training traces
    eval_every_rounds: int = 4
    # fault injection (sim.faults): None = the benign, fault-free world.
    # A FaultParams activates the deterministic fault plane — Gilbert-
    # Elliott link blackout bursts, correlated crash/recover, stragglers,
    # stale planner inputs, heartbeat-driven survivor replans.
    faults: Optional[FaultParams] = None
    # how effective_w degrades when faults/outage knock planned links out:
    # "renorm" re-row-normalizes the delivered graph (graceful), "naive"
    # keeps the planned weights with lost links zeroed (rows sum < 1)
    degrade: str = "renorm"
    # NaN/divergence watchdog in the train-on-trace scan (sim.batch): a
    # node whose post-step parameters go non-finite is rolled back to its
    # last good snapshot and rejoins through the next round's mix
    watchdog: bool = False

    def __post_init__(self):
        if self.mac_kind not in MAC_KINDS:
            raise ValueError(
                f"mac_kind must be one of {MAC_KINDS}, got {self.mac_kind!r}")
        if self.policy not in POLICY_KINDS:
            raise ValueError(
                f"policy must be one of {POLICY_KINDS}, got {self.policy!r}")
        if self.payload.mode not in SCENARIO_PAYLOAD_MODES:
            raise ValueError(
                f"payload.mode must be one of {SCENARIO_PAYLOAD_MODES}, "
                f"got {self.payload.mode!r}")
        if self.reference_mac and self.resolved_policy() != "tdm":
            # there is no pinned-loop RA/BASS MAC; silently running the fast
            # round on a config that asked for the reference would make
            # fast-vs-reference cross-checks pass vacuously
            raise ValueError(
                "reference_mac applies to the TDM MAC only; the other "
                "policies have a single round implementation (their pinned "
                "references live in access_opt/sched_opt)")
        if self.resolved_policy() == "bass" and self.payload.mode == "auto":
            raise ValueError(
                "policy=\"bass\" plans rates and transmit fractions; the "
                "joint rate x payload sweep is not wired into sched_opt — "
                "pick a concrete payload.mode")
        if self.model_shapes:
            shapes = tuple(tuple(int(d) for d in s) for s in self.model_shapes)
            object.__setattr__(self, "model_shapes", shapes)
            total_bits = sum(
                32.0 * _prod(s) for s in shapes)
            if abs(total_bits - self.model_bits) > 0.5:
                raise ValueError(
                    f"model_shapes sums to {total_bits} fp32 bits but "
                    f"model_bits={self.model_bits}; the airtime model and "
                    "the shape accounting would silently disagree")
        if self.payload.granularity == "leaf":
            if not self.model_shapes:
                raise ValueError(
                    "payload.granularity=\"leaf\" needs model_shapes: "
                    "per-leaf framing cannot be charged from a flat "
                    "model_bits count")
            if self.payload.mode == "auto":
                raise ValueError(
                    "payload.mode=\"auto\" resolves wire bits through the "
                    "scalar joint planner; per-leaf granularity needs a "
                    "concrete mode")
        if self.degrade not in DEGRADE_MODES:
            raise ValueError(
                f"degrade must be one of {DEGRADE_MODES}, "
                f"got {self.degrade!r}")
        if (self.faults is not None
                and self.faults.crash_p > 0
                and self.faults.keep_min > self.n_nodes):
            raise ValueError(
                "faults.keep_min exceeds n_nodes: the crash process could "
                "never fire and the config is almost surely a typo")

    def resolved_policy(self) -> str:
        """The scheduling-policy kind a simulator will instantiate:
        ``policy`` verbatim, or — ``"auto"`` — the pre-policy mapping from
        ``mac_kind`` (kept so every pre-policy config runs bit-identically
        through the policy plane)."""
        if self.policy != "auto":
            return self.policy
        return "uniform_ra" if self.mac_kind == "random_access" else "tdm"

    def wire_bits(self) -> float:
        """Exact bits one node's broadcast puts on the air under ``payload``
        — ``model_bits`` verbatim for ``"none"``, otherwise
        ``compression.payload_bits`` of the model's fp32 lane count (int8:
        whole padded blocks + one fp32 scale each). With ``model_shapes``
        set this is ``compression.payload_bits_tree``, which additionally
        charges the per-leaf tail padding when
        ``payload.granularity == "leaf"`` (for ``"message"`` granularity
        the tree and flat accountings agree exactly). ``"auto"`` has no
        fixed answer: the joint planner resolves it per replan."""
        if self.payload.mode == "auto":
            raise ValueError(
                "payload.mode=\"auto\" is resolved per replan by the joint "
                "planner; ask the simulator (or its RoundRecords) instead")
        if self.model_shapes:
            from ..core.compression import payload_bits_tree
            return payload_bits_tree(self.model_shapes, self.payload)
        from ..core.rate_opt import payload_wire_bits
        return payload_wire_bits(self.model_bits, self.payload.mode)

    def channel_params(self) -> ChannelParams:
        return ChannelParams(
            p_tx_dbm=self.p_tx_dbm,
            bandwidth_hz=self.bandwidth_hz,
            noise_floor_dbm=self.noise_floor_dbm,
            path_loss_exp=self.path_loss_exp,
            fading_margin_bps=self.fading_margin_bps,
        )

    def replace(self, **kw) -> "ScenarioConfig":
        """``dataclasses.replace`` extended to reach **nested** param
        dataclasses: a dotted key (``**{"ra.max_slots": 8}``, arbitrary
        depth) or a dict value on a dataclass field (``ra={"max_slots": 8}``)
        merges into the existing nested value instead of requiring a
        hand-built replacement dataclass. Unknown field names raise."""
        return _nested_replace(self, kw)


def _nested_replace(obj, overrides: dict):
    """Recursive ``dataclasses.replace``: dotted keys and dict-valued
    overrides of dataclass fields merge into the nested value."""
    flat: dict = {}
    nested: dict[str, dict] = {}
    for key, val in overrides.items():
        if "." in key:
            head, rest = key.split(".", 1)
            nested.setdefault(head, {})[rest] = val
        elif isinstance(val, dict) and dataclasses.is_dataclass(
                getattr(obj, key, None)):
            nested.setdefault(key, {}).update(val)
        else:
            flat[key] = val
    for head, sub in nested.items():
        if head in flat:
            raise ValueError(
                f"conflicting overrides for field {head!r}: both a whole-"
                f"value replacement and nested keys {sorted(sub)}")
        current = getattr(obj, head, None)
        if not dataclasses.is_dataclass(current):
            raise ValueError(
                f"cannot apply nested override {head!r}: "
                f"{type(obj).__name__}.{head} is not a param dataclass")
        flat[head] = _nested_replace(current, sub)
    return dataclasses.replace(obj, **flat)


_REGISTRY: dict[str, ScenarioConfig] = {}


def register(cfg: ScenarioConfig) -> ScenarioConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"scenario {cfg.name!r} already registered")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_scenario(name: str, **overrides) -> ScenarioConfig:
    try:
        base = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; known: {sorted(_REGISTRY)}") from None
    return base.replace(**overrides) if overrides else base


def list_scenarios() -> list[str]:
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Built-in scenarios
# ---------------------------------------------------------------------------

register(ScenarioConfig(name="static"))

register(ScenarioConfig(
    name="fading",
    fading=FadingParams(rayleigh=True, shadowing_sigma_db=3.0,
                        shadowing_corr=0.9, coherence_s=0.01),
    # plan with headroom: the margin trades rate for outage probability
    # (2 Mbps margin + lambda 0.5 keeps Eq. 8 feasible at ~20 % link outage;
    # sparser targets are faster but fall apart under deep fades)
    fading_margin_bps=2e6,
    lambda_target=0.5,
    mac=MacParams(max_retx_rounds=3),
))

register(ScenarioConfig(
    name="mobile",
    mobility_kind="waypoint",
    speed_mps=5.0,
    replan_drift_rel=0.15,        # re-run Algorithm 2 when C drifts >= 15 %
    replan_every_rounds=16,       # …and at least this often
))

register(ScenarioConfig(
    name="churn",
    churn_rate_per_s=0.15,
))

register(ScenarioConfig(
    name="ra_static",
    mac_kind="random_access",
))

register(ScenarioConfig(
    name="ra_fading",
    mac_kind="random_access",
    fading=FadingParams(rayleigh=True, shadowing_sigma_db=3.0,
                        shadowing_corr=0.9, coherence_s=0.01),
    fading_margin_bps=2e6,
    lambda_target=0.5,
    # a binding slot budget: links that lose the contention + fading race
    # drop out of that round's W — the subgraph-sampled mixing graph of
    # Herrera et al., random per round
    ra=RAParams(max_slots=24),
))

register(ScenarioConfig(
    name="ra_capture",
    mac_kind="random_access",
    # 6 dB SINR capture: the strongest colliding broadcast can still decode,
    # so coverage needs fewer slots than the pure-collision model; the
    # sparser density target (higher rates, shorter slots) makes contention
    # the binding constraint rather than slot airtime
    lambda_target=0.5,
    ra=RAParams(capture_db=6.0),
))

_FADING = FadingParams(rayleigh=True, shadowing_sigma_db=3.0,
                       shadowing_corr=0.9, coherence_s=0.01)

register(ScenarioConfig(
    name="compressed_bf16",
    fading=_FADING,
    fading_margin_bps=2e6,
    lambda_target=0.5,
    mac=MacParams(max_retx_rounds=3),
    payload=QuantConfig(mode="bf16", error_feedback=False),
))

register(ScenarioConfig(
    # the acceptance scenario: dense fading world, int8 + error feedback —
    # round airtime drops by the exact payload_bits ratio (~3.9x for the
    # paper's CNN) while EF keeps train-on-trace accuracy at fp32 level
    name="compressed_int8",
    fading=_FADING,
    fading_margin_bps=2e6,
    lambda_target=0.5,
    mac=MacParams(max_retx_rounds=3),
    payload=QuantConfig(mode="int8", error_feedback=True),
))

register(ScenarioConfig(
    # compression under contention: shorter slots (wire_bits / min R), same
    # coupon-collector coverage race — the slot *budget* binds less in time
    name="compressed_ra",
    mac_kind="random_access",
    fading=_FADING,
    fading_margin_bps=2e6,
    lambda_target=0.5,
    ra=RAParams(max_slots=24),
    payload=QuantConfig(mode="int8", error_feedback=True),
))

register(ScenarioConfig(
    # the paper's static world under subgraph sampling: sched_opt picks
    # (rates, transmit fraction) for time-to-accuracy; at f=1 the grouped
    # collision-free schedule is a spatial-reuse TDM (round time <= Eq. 3)
    name="bass_static",
    policy="bass",
))

register(ScenarioConfig(
    # the acceptance scenario for policy_compare: same fading world as
    # "fading"/"ra_fading", but the realized per-round subgraph is *chosen*
    # (importance-sampled collision-free groups) instead of contention-lost
    name="bass_fading",
    policy="bass",
    fading=_FADING,
    fading_margin_bps=2e6,
    lambda_target=0.5,
))

register(ScenarioConfig(
    # energy-budgeted BASS: every node duty-cycled to half the rounds; the
    # planner scores E[W] at the capped marginal q = min(f, duty_cycle)
    name="bass_energy",
    policy="bass",
    fading=_FADING,
    fading_margin_bps=2e6,
    lambda_target=0.5,
    bass=BASSParams(duty_cycle=0.5),
))

register(ScenarioConfig(
    # the fading world under bursty link blockage: a Gilbert-Elliott chain
    # per node pair blacks links out for ~3-round bursts (mean 1/p_recover),
    # far past one coherence block — the correlated-outage tail the fading
    # margin alone cannot absorb. Extra retx passes model ARQ riding
    # through the burst; effective_w degrades gracefully (renorm).
    name="fault_burst",
    fading=FadingParams(rayleigh=True, shadowing_sigma_db=3.0,
                        shadowing_corr=0.9, coherence_s=0.01),
    fading_margin_bps=2e6,
    lambda_target=0.5,
    mac=MacParams(max_retx_rounds=3),
    faults=FaultParams(link_p_fail=0.08, link_p_recover=0.35),
))

register(ScenarioConfig(
    # correlated crash/recover + the heartbeat recovery loop: a crash event
    # takes the victim plus ~30 % of the other nodes down for 5 rounds;
    # missed heartbeats trip the controller after ~2 round-times (rounds on
    # the pinned placement stream run 0.03-0.1 simulated seconds), the
    # survivors replan (with the common-rate fallback if their graph
    # disconnects), and crashed nodes rejoin with stale parameters.
    name="fault_crash",
    replan_every_rounds=8,
    faults=FaultParams(crash_p=0.10, crash_corr=0.3, crash_down_rounds=5,
                       heartbeat_timeout_s=0.15),
))

register(ScenarioConfig(
    # stragglers + a lagging control plane: each round each node runs 4x
    # slower with p=0.15 (its slots stretch on the simulated clock), and
    # every replan sees the capacity matrix from 3 rounds ago while nodes
    # keep moving — plans chase a stale world, so outage shows up even
    # where the instantaneous channel would have been fine.
    name="fault_stragglers",
    mobility_kind="waypoint",
    speed_mps=5.0,
    replan_every_rounds=8,
    replan_drift_rel=0.15,
    faults=FaultParams(straggler_p=0.15, straggler_factor=4.0,
                       plan_staleness_rounds=3),
))

register(ScenarioConfig(
    # everything at once, plus the scan-plane watchdog: the chaos scenario
    # the registry-wide smoke and the fault_compare bench lean on.
    name="fault_chaos",
    fading=FadingParams(rayleigh=True, shadowing_sigma_db=3.0,
                        shadowing_corr=0.9, coherence_s=0.01),
    fading_margin_bps=2e6,
    lambda_target=0.5,
    mac=MacParams(max_retx_rounds=3),
    replan_every_rounds=8,
    faults=FaultParams(link_p_fail=0.05, link_p_recover=0.35,
                       crash_p=0.08, crash_corr=0.25, crash_down_rounds=4,
                       straggler_p=0.10, straggler_factor=3.0,
                       plan_staleness_rounds=2, heartbeat_timeout_s=1.0),
    watchdog=True,
))

register(ScenarioConfig(
    name="mixed",
    fading=FadingParams(rayleigh=True, shadowing_sigma_db=3.0,
                        shadowing_corr=0.9, coherence_s=0.01),
    fading_margin_bps=2e6,
    lambda_target=0.5,
    mobility_kind="cluster",
    speed_mps=3.0,
    churn_rate_per_s=0.1,
    replan_every_rounds=8,
    replan_drift_rel=0.2,
    mac=MacParams(max_retx_rounds=3),
))
