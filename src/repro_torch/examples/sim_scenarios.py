"""Drive the discrete-event wireless simulator across its named scenarios.

The torch counterpart of ``examples/sim_scenarios.py``, on the paper's
setup (n=6 nodes, 200 m square, the 21 840-param CNN message):

1. ``--compare``  (default) — run every registered scenario comm-only and
   print a summary table: simulated communication time, outage rate,
   retransmissions, Algorithm 2 replans, node failures. The ``static`` row
   is exactly the paper's Eq. 3 world; the others show what the frozen
   model hides.
2. ``--train SCENARIO`` — train D-PSGD through the simulator on ``--device``
   and print the accuracy-vs-**simulated-wall-clock** curve (the paper's
   Fig. 3(c-f) axis, but with time-varying channels); each round's compute
   time is the device's measured step.
3. ``--margin-sweep`` — sweep ``fading_margin_bps`` under the fading
   scenario: the §II-B margin becomes a real dial between outage rate
   (too little headroom) and airtime (too much).
4. ``--mac-compare`` — TDM vs random access head to head: the CNN trained
   through both MAC planes on the same placement, accuracy stamped with
   each plane's own simulated clock.
5. ``--policy-compare`` — TDM vs uniform random access vs BASS subgraph
   sampling on the same fading world, accuracy vs each policy's own
   simulated clock plus a time-to-accuracy summary.

The two compare demos train each scenario through the per-round driver
(``sim.simulate_dpsgd_cnn``, compute charged at ``compute_s_per_round``),
which shares the JAX package's batched train-on-trace path's sampling
contract; the batched path itself, ``--train-sweep``, waits for ROADMAP
Queue 1 item 2, and ``--scale`` (the jitted scan engine) for item 4.

``--scenario PATTERN`` restricts the ``--compare`` table to scenarios whose
name matches the glob. ``--payload MODE`` overrides the gossip payload
compression of every scenario the chosen demo touches
(``none``/``bf16``/``int8``, or ``auto`` for the comm-only tables).

Usage:
    PYTHONPATH=src python -m repro_torch.examples.sim_scenarios
    PYTHONPATH=src python -m repro_torch.examples.sim_scenarios --payload int8
    PYTHONPATH=src python -m repro_torch.examples.sim_scenarios \\
        --train compressed_int8 --epochs 1
    PYTHONPATH=src python -m repro_torch.examples.sim_scenarios \\
        --train compressed_int8 --device cpu --epochs 1
    PYTHONPATH=src python -m repro_torch.examples.sim_scenarios --margin-sweep
    PYTHONPATH=src python -m repro_torch.examples.sim_scenarios --mac-compare
"""
from __future__ import annotations

import argparse
import fnmatch

from ..sim import (QuantConfig, WirelessSimulator, get_scenario,
                   list_scenarios, simulate_dpsgd_cnn)


def _fetch(name: str, payload: str | None, **overrides):
    """``get_scenario`` + the optional ``--payload`` override, with the
    registry's error-feedback convention: EF on for int8 only (bf16 rounding
    is benign enough to skip the residual state — ``compressed_bf16`` ships
    EF off, and the override must train the same algorithm)."""
    if payload is not None:
        overrides["payload"] = QuantConfig(mode=payload,
                                           error_feedback=payload == "int8")
    return get_scenario(name, **overrides)


def compare(rounds: int, solver: str, pattern: str = "*",
            payload: str | None = None) -> None:
    names = [n for n in list_scenarios() if fnmatch.fnmatch(n, pattern)]
    if not names:
        raise SystemExit(f"no registered scenario matches {pattern!r}")
    print(f"{'scenario':>15} {'policy':>6} {'payload':>7} {'Mb/bcast':>8} "
          f"{'comm_s':>9} {'outage':>7} "
          f"{'retx':>6} {'replans':>7} {'fails':>5} {'n_end':>5}")
    for name in names:
        if payload == "auto" and \
                get_scenario(name).resolved_policy() == "bass":
            # sched_opt plans rates and fractions, not payload modes; keep
            # the registered payload so the table still shows the bass rows
            cfg = get_scenario(name, solver=solver)
        else:
            cfg = _fetch(name, payload, solver=solver)
        trace = WirelessSimulator(cfg).run(rounds)
        s = trace.summary()
        mac = {"uniform_ra": "ra"}.get(cfg.resolved_policy(),
                                       cfg.resolved_policy())
        last = trace.records[-1]
        print(f"{name:>15} {mac:>6} {last.payload_mode:>7} "
              f"{last.wire_bits / 1e6:>8.3f} {s['total_comm_s']:>9.2f} "
              f"{s['outage_rate']:>7.2%} "
              f"{s['retx_packets']:>6d} {s['replans']:>7d} "
              f"{s['failures']:>5d} {s['final_n_live']:>5d}")


def _train_each(cfgs, epochs: int, device: str) -> list:
    """Each scenario through the per-round driver at the compare demos'
    size (600 / 150 images); compute charged at ``compute_s_per_round``."""
    return [simulate_dpsgd_cnn(cfg, epochs=epochs, n_train=600, n_test=150,
                               device=device)[0] for cfg in cfgs]


def mac_compare(epochs: int, payload: str | None = None,
                device: str = "cuda") -> None:
    """Same placement, same CNN, two MACs: accuracy vs each plane's own
    simulated wall-clock — what collision-free scheduling is worth."""
    cfgs = [_fetch("static", payload, eval_every_rounds=2),
            _fetch("ra_static", payload, eval_every_rounds=2),
            _fetch("ra_capture", payload, eval_every_rounds=2)]
    traces = _train_each(cfgs, epochs, device)
    print("scenario,mac,t_sim_s,accuracy")
    for cfg, trace in zip(cfgs, traces):
        mac = "ra" if cfg.mac_kind == "random_access" else "tdm"
        for t, acc in trace.accuracy_curve():
            print(f"{cfg.name},{mac},{t:.2f},{acc:.4f}")
    for cfg, trace in zip(cfgs, traces):
        s = trace.summary()
        print(f"# {cfg.name}: comm {s['total_comm_s']:.1f}s, "
              f"final acc {s['final_acc']:.4f}")


def policy_compare(epochs: int, payload: str | None = None,
                   device: str = "cuda") -> None:
    """Same fading world, three scheduling policies: accuracy vs each
    policy's own simulated wall-clock, plus time-to-accuracy — what chosen
    collision-free subgraphs are worth over a fixed schedule (TDM) and
    over contention-lost random subgraphs (uniform RA)."""
    cfgs = [_fetch("fading", payload, eval_every_rounds=2),
            _fetch("ra_fading", payload, eval_every_rounds=2),
            _fetch("bass_fading", payload, eval_every_rounds=2)]
    traces = _train_each(cfgs, epochs, device)
    print("scenario,policy,t_sim_s,accuracy")
    for cfg, trace in zip(cfgs, traces):
        for t, acc in trace.accuracy_curve():
            print(f"{cfg.name},{cfg.resolved_policy()},{t:.2f},{acc:.4f}")
    target = min(trace.summary()["final_acc"] for trace in traces)
    for cfg, trace in zip(cfgs, traces):
        s = trace.summary()
        tta = next((t for t, a in trace.accuracy_curve() if a >= target),
                   float("inf"))
        print(f"# {cfg.name} ({cfg.resolved_policy()}): comm "
              f"{s['total_comm_s']:.1f}s, final acc {s['final_acc']:.4f},"
              f" reaches acc {target:.3f} at {tta:.1f}s sim")


def train(name: str, epochs: int, solver: str, payload: str | None = None,
          device: str = "cuda") -> None:
    cfg = _fetch(name, payload, solver=solver, eval_every_rounds=2)
    trace, _ = simulate_dpsgd_cnn(cfg, epochs=epochs, n_train=1200,
                                  n_test=300, measure_compute=True,
                                  device=device)
    s = trace.summary()
    print(f"# {name} on {device}: {s['rounds']} rounds, sim time "
          f"{s['t_end_s']:.1f}s (comm {s['total_comm_s']:.1f}s + compute "
          f"{s['total_compute_s']:.1f}s), outage {s['outage_rate']:.1%}, "
          f"replans {s['replans']}, failures {s['failures']}")
    print("t_sim_s,accuracy")
    for t, acc in trace.accuracy_curve():
        print(f"{t:.2f},{acc:.4f}")


def margin_sweep(rounds: int, solver: str, payload: str | None = None) -> None:
    print("fading_margin_bps,feasible,outage_rate,retx_packets,comm_s")
    for margin in (0.0, 5e5, 1e6, 2e6, 3e6, 4e6):
        cfg = _fetch("fading", payload, fading_margin_bps=margin,
                     solver=solver)
        sim = WirelessSimulator(cfg)
        trace = sim.run(rounds)
        s = trace.summary()
        print(f"{margin:.0f},{sim.solution.feasible},"
              f"{s['outage_rate']:.3f},{s['retx_packets']},"
              f"{s['total_comm_s']:.2f}")


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--compare", action="store_true",
                      help="scenario comparison table (default)")
    mode.add_argument("--train", metavar="SCENARIO", choices=list_scenarios())
    mode.add_argument("--train-sweep", metavar="SCENARIO",
                      choices=list_scenarios(),
                      help="not ported yet (ROADMAP Queue 1 item 2)")
    mode.add_argument("--margin-sweep", action="store_true")
    mode.add_argument("--scale", type=int, metavar="N",
                      help="not ported yet (ROADMAP Queue 1 item 4)")
    mode.add_argument("--mac-compare", action="store_true",
                      help="TDM vs random-access accuracy-vs-sim-time")
    mode.add_argument("--policy-compare", action="store_true",
                      help="TDM vs uniform-RA vs BASS accuracy-vs-sim-time "
                           "+ time-to-accuracy")
    p.add_argument("--scenario", default="*", metavar="PATTERN",
                   help="glob filter for --compare (e.g. 'ra_*')")
    p.add_argument("--payload", default=None,
                   choices=["none", "bf16", "int8", "auto"],
                   help="override gossip payload compression ('auto' lets "
                        "the joint planner pick; comm-only demos — the "
                        "training demos need a concrete mode)")
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--solver", default="greedy",
                   help="rate_opt method for (re)plans; 'auto' = exact")
    p.add_argument("--device", default="cuda",
                   help="device of the training demos ('cpu' runs the "
                        "kernels' plain versions)")
    args = p.parse_args(argv)
    if args.train_sweep:
        p.error("--train-sweep trains through sim/batch.py (train-on-trace),"
                " which is not ported yet: ROADMAP Queue 1 item 2")
    if args.scale:
        p.error("--scale runs the jitted scan engine (sim/jit_trace.py), "
                "which is not ported yet: ROADMAP Queue 1 item 4")
    if args.payload == "auto" and (args.train or args.mac_compare
                                   or args.policy_compare):
        p.error("--payload auto is comm-only (--compare / --margin-sweep); "
                "pick none/bf16/int8 for the training demos")
    if args.train:
        train(args.train, args.epochs, args.solver, args.payload, args.device)
    elif args.margin_sweep:
        margin_sweep(args.rounds, args.solver, args.payload)
    elif args.mac_compare:
        mac_compare(args.epochs, args.payload, args.device)
    elif args.policy_compare:
        policy_compare(args.epochs, args.payload, args.device)
    else:
        compare(args.rounds, args.solver, args.scenario, args.payload)


if __name__ == "__main__":
    main()
