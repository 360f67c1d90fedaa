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
4. ``--train-sweep SCENARIO --seeds N`` — the train-on-trace plane:
   channel realizations for N seeds precomputed driver-less, then the
   whole Monte-Carlo family trained on ``--device`` with one graph replay
   per round for the family (``sim.batch.train_cnn_on_traces``); prints
   the per-seed accuracy-vs-simulated-time curves.
5. ``--mac-compare`` — TDM vs random access head to head: the CNN trained
   through both MAC planes on the same placement in one
   ``train_cnn_on_traces`` family, accuracy stamped with each plane's own
   simulated clock.
6. ``--policy-compare`` — TDM vs uniform random access vs BASS subgraph
   sampling on the same fading world, accuracy vs each policy's own
   simulated clock plus a time-to-accuracy summary.

7. ``--scale N`` — large-n smoke: one certified Algorithm 2 replan at N
   nodes, then a Rayleigh-only fading trace of ``--rounds`` rounds through
   the scan engine (``sim.jit_trace``: the round loop in one launch of
   ``csrc/trace_scan.cu`` on ``--device``).

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
    PYTHONPATH=src python -m repro_torch.examples.sim_scenarios \\
        --train-sweep fading --seeds 4
    PYTHONPATH=src python -m repro_torch.examples.sim_scenarios \\
        --train-sweep static --epochs 1 --device cpu
    PYTHONPATH=src python -m repro_torch.examples.sim_scenarios --mac-compare
    PYTHONPATH=src python -m repro_torch.examples.sim_scenarios \\
        --policy-compare --device cpu
    PYTHONPATH=src python -m repro_torch.examples.sim_scenarios \\
        --scale 1024 --rounds 30
    PYTHONPATH=src python -m repro_torch.examples.sim_scenarios \\
        --scale 128 --rounds 2 --device cpu
"""
from __future__ import annotations

import argparse
import fnmatch

from ..sim import (QuantConfig, WirelessSimulator, get_scenario,
                   list_scenarios, simulate_dpsgd_cnn, train_cnn_on_traces)


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


def mac_compare(epochs: int, payload: str | None = None,
                device: str = "cuda") -> None:
    """Same placement, same CNN, two MACs: accuracy vs each plane's own
    simulated wall-clock — what collision-free scheduling is worth."""
    cfgs = [_fetch("static", payload, eval_every_rounds=2),
            _fetch("ra_static", payload, eval_every_rounds=2),
            _fetch("ra_capture", payload, eval_every_rounds=2)]
    traces, out = train_cnn_on_traces(cfgs, epochs=epochs, n_train=600,
                                      n_test=150, device=device)
    print("scenario,mac,t_sim_s,accuracy")
    for k, cfg in enumerate(cfgs):
        mac = "ra" if cfg.mac_kind == "random_access" else "tdm"
        for t, acc in out["curves"][k]:
            print(f"{cfg.name},{mac},{t:.2f},{acc:.4f}")
    for k, cfg in enumerate(cfgs):
        s = traces.traces[k].trace.summary()
        print(f"# {cfg.name}: comm {s['total_comm_s']:.1f}s, "
              f"final acc {out['acc'][k, -1]:.4f}")


def policy_compare(epochs: int, payload: str | None = None,
                   device: str = "cuda") -> None:
    """Same fading world, three scheduling policies: accuracy vs each
    policy's own simulated wall-clock, plus time-to-accuracy — what chosen
    collision-free subgraphs are worth over a fixed schedule (TDM) and
    over contention-lost random subgraphs (uniform RA)."""
    cfgs = [_fetch("fading", payload, eval_every_rounds=2),
            _fetch("ra_fading", payload, eval_every_rounds=2),
            _fetch("bass_fading", payload, eval_every_rounds=2)]
    traces, out = train_cnn_on_traces(cfgs, epochs=epochs, n_train=600,
                                      n_test=150, device=device)
    print("scenario,policy,t_sim_s,accuracy")
    for k, cfg in enumerate(cfgs):
        for t, acc in out["curves"][k]:
            print(f"{cfg.name},{cfg.resolved_policy()},{t:.2f},{acc:.4f}")
    target = float(out["acc"][:, -1].min())
    for k, cfg in enumerate(cfgs):
        s = traces.traces[k].trace.summary()
        tta = next((t for t, a in out["curves"][k] if a >= target),
                   float("inf"))
        print(f"# {cfg.name} ({cfg.resolved_policy()}): comm "
              f"{s['total_comm_s']:.1f}s, final acc {out['acc'][k, -1]:.4f},"
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


def train_sweep(name: str, seeds: int, epochs: int, solver: str,
                payload: str | None = None, device: str = "cuda") -> None:
    """Monte-Carlo accuracy-vs-simulated-time family, one graph replay per
    round for the whole family."""
    import time

    cfgs = [_fetch(name, payload, seed=s, solver=solver, eval_every_rounds=2)
            for s in range(seeds)]
    t0 = time.perf_counter()
    traces, out = train_cnn_on_traces(cfgs, epochs=epochs, n_train=600,
                                      n_test=300, device=device)
    dt = time.perf_counter() - t0
    print(f"# {name} on {device}: {seeds} seeds x {traces.n_rounds} rounds "
          f"in {dt:.2f}s wall (one graph replay per round)")
    print("seed,t_sim_s,accuracy")
    for s, curve in enumerate(out["curves"]):
        for t, acc in curve:
            print(f"{s},{t:.2f},{acc:.4f}")
    final = out["acc"][:, -1]
    print(f"# final accuracy over seeds: mean {final.mean():.4f} "
          f"min {final.min():.4f} max {final.max():.4f}")


def scale(n: int, rounds: int, device: str = "cuda") -> None:
    """Large-n smoke: one Algorithm 2 replan (the certified local-candidate
    sweep above ``core.topology.ITERATIVE_MIN_N``) plus a scan-engine
    fading trace at n nodes on ``device``, Rayleigh-only (the scan plane's
    stateless per-block RNG carries no AR(1) shadowing)."""
    import time

    from ..core.topology import spectral_lambda
    from ..sim.jit_trace import precompute_trace_scan

    cfg = get_scenario("fading", n_nodes=n,
                       **{"fading.shadowing_sigma_db": 0.0})
    t0 = time.perf_counter()
    sim = WirelessSimulator(cfg)
    t_plan = time.perf_counter() - t0
    sol = sim.solution
    certified = sol.lam == spectral_lambda(sol.w)
    t0 = time.perf_counter()
    tr = precompute_trace_scan(cfg, rounds, sim=sim, device=device)
    t_trace = time.perf_counter() - t0
    s = tr.trace.summary()
    print(f"# n={n}: plan {t_plan:.2f}s (lambda {sol.lam:.4f} <= "
          f"{cfg.lambda_target} target, feasible={sol.feasible}, "
          f"certified={certified}), {rounds} rounds in {t_trace:.2f}s "
          f"({rounds / t_trace:.2f} rounds/s), outage "
          f"{s['outage_rate']:.1%}, comm {s['total_comm_s']:.1f}s sim")
    assert certified and sol.feasible, "large-n plan not certified-feasible"


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
                      help="Monte-Carlo family via the batched "
                           "train-on-trace path")
    mode.add_argument("--margin-sweep", action="store_true")
    mode.add_argument("--scale", type=int, metavar="N",
                      help="large-n smoke: certified replan + scan-engine "
                           "fading trace at N nodes (Rayleigh-only)")
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
    p.add_argument("--seeds", type=int, default=4,
                   help="channel seeds for --train-sweep")
    p.add_argument("--solver", default="greedy",
                   help="rate_opt method for (re)plans; 'auto' = exact")
    p.add_argument("--device", default="cuda",
                   help="device of the training demos and of --scale's "
                        "trace ('cpu' runs the kernels' plain versions)")
    args = p.parse_args(argv)
    if args.payload == "auto" and (args.train or args.train_sweep
                                   or args.mac_compare
                                   or args.policy_compare):
        p.error("--payload auto is comm-only (--compare / --margin-sweep); "
                "pick none/bf16/int8 for the training demos")
    if args.train:
        train(args.train, args.epochs, args.solver, args.payload, args.device)
    elif args.train_sweep:
        train_sweep(args.train_sweep, args.seeds, args.epochs, args.solver,
                    args.payload, args.device)
    elif args.scale:
        scale(args.scale, args.rounds, args.device)
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
