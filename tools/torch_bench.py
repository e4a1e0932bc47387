#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: atom-steps/s of the 97,920-atom MoS2
REBOMOS NVE bench scene on one NVIDIA GPU (f32) — the port's counterpart
of bench.py, which stays the JAX package's.

    python3 tools/torch_bench.py [--steps 1000] [--reps 5] [--eager]
                                 [--drift-steps 2000]

The scene and settings are bench.py's (bench.py:118-186):
rebomos_bulk_commensurate(34, 48, 10), f32, 300 K from velocity_create(
seed=12345), skin 0.8, displacement check every 10 steps; the parameters
are tests/data/MoS.REBO.synthetic (bench.py reads the published set5b,
which the repository does not hold).  The Engine runs its default loop on
the card, the device loop's CUDA graphs; --eager runs the host loop
(fused_loop=False) instead.  After a warm-up run (plan sizing, kernel
build, capture), `--reps` timed windows of `--steps` steps each include
their neighbor rebuilds.

Prints one JSON line with bench.py's fields (bench.py:217-279): the
metric, its value (the best window) and vs_baseline (against the
reference's 34,223 atom-steps/s, log.rebomos-bulk.1:59), the NVE
total-energy drift over at least `--drift-steps` steps and its 1e-6
eV/step/atom bound, and max|F_f32 - F_f64| / RMS(F) on the 288-atom scene
(f32 on the card against the port's f64 CPU twins) and its 1e-2 bound;
beside them the median of the windows, every window, the rebuilds in
each, the peak device memory, and the card's name and power limit.

    python3 tools/torch_bench.py --aeam [--poly] [--steps 480] [--reps 3]

is the port's counterpart of benchmarks/bench_aeam.py: the
USER-AEAM/sample.in workload, 32,000-atom fcc Al with 0.75 % Si
(alsi_sample(nc=20)), f32, NVT at 863 K (FixNVT(863, 863, 0.1), velocities
from velocity_create(seed=4928459)), skin 1.2, a check every 12 steps,
pair_style aeam from tests/data/AlSi.synthetic.aeam on its exact
table-spline path (--poly: the piecewise-Chebyshev refits, bench_aeam.py's
default for the TPU, slower than the spline rows on the H100: PERF.md),
a 288-step warm-up.  The graph loop and the eager loop each get their own Engine and
run their timed windows in turns.  Prints bench_aeam.py's fields (metric,
value = the best window, unit; PE/atom, K, the warm-up, the timers' split)
for each loop, the median beside the best, the NVT conserved quantity's
drift over the timed windows, the peak memory, and the card's name and
power limit, as one JSON line.

    python3 tools/torch_bench.py --melt | --lj | --monolayer [--steps N]
                                 [--reps R]

run the same two-loop measurement on the other workloads: --melt, config
2, tests/test_ljcut.py's charged LJ/Coulomb melt at n = 32 (65,536 ions,
lj/cut/coul/cut 6 / 8, fix bfield 0 0 200 T, fix nve, skin 1.0; 300-step
windows); --lj, LAMMPS's bench/in.lj (lj_melt(20), 32,000 atoms, lj/cut
2.5, skin 0.3; 500-step windows); --monolayer, config 4, the 1,000,518-atom
MoS2 monolayer (rebomos_monolayer(577, 578), REBOMOS NVT 300 K from seed
12345, skin 0.8, check every 10; 100-step windows).  The decks watch the
NVE total energy's drift, the NVT workloads the conserved quantity's.

    python3 tools/torch_bench.py --sharded 2x2|slabs|config5
                                 [--placement stacked|per_device]
                                 [--steps N] [--reps R]

runs the sharded engine on the card: the bench scene in the reference's
2x2 processor grid or in four x-slabs, or config 5 (7,999,488 atoms in
eight x-slabs, benchmarks/scale_multichip.py:45-49), its shards stacked
on cuda:0 or per device (one stream a shard, over min(count, 4) cards:
one card gives every shard its own stream on it).  The bench-scene
layouts run their windows in turns with the single-device Engine on the
same scene (300-step windows); config 5 alone (100-step windows: a second
8M-atom engine does not fit beside it).  Prints atom-steps/s of each
window, the median, the resettles, the peak memory and the card's name
and power limit as one JSON line.

Every Engine comes from chip_smoke.py (bench_engine, aeam_engine,
deck_engine, mono_engine, shard_bench, scale_engine), so the bench times
the cells that the smoke script checks.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REBO_FILE = os.path.join(REPO, "tests", "data", "MoS.REBO.synthetic")
BASELINE = 34223.0          # log.rebomos-bulk.1:59, katom-step/s * 1000


def f32_force_error(dev):
    """(max |F_f32 - F_f64|, RMS(F)) on the 288-atom scene: the f32 path on
    the card against the f64 twins on the CPU, on each one's own lists."""
    import numpy as np
    import torch
    from lammps_plugins_tpu_torch.api.scenes import rebomos_bulk
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    from lammps_plugins_tpu_torch.run.simulation import Engine

    def forces(dtype, device):
        pair = REBOMoS.from_file(REBO_FILE, ["M", "S"], dtype=dtype,
                                 device=device)
        eng = Engine(rebomos_bulk(dtype=dtype, device=device), pair,
                     [FixNVE()], units.METAL)
        eng.rebuild_neighbors()
        st = eng.state
        with torch.no_grad():
            f = pair.forces(st.x, st.type, eng.nbr, st.box.h)
        return f.double().cpu().numpy()

    f64 = forces(torch.float64, "cpu")
    f32 = forces(torch.float32, dev)
    return float(np.abs(f32 - f64).max()), float(np.sqrt(np.mean(f64 * f64)))


def gpu_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


#: the workloads that run both loops: steps a window, windows each loop,
#: warm-up steps, and whether a thermostat's energy joins the conserved
#: quantity (pe + ke + FixNVT.energy) or the NVE total energy is watched
WORKLOADS = {
    "aeam": dict(steps=480, reps=3, warmup=288, nvt=True,
                 metric="AlSi AEAM NVT 863K, f32"),
    "melt": dict(steps=300, reps=3, warmup=300, nvt=False,
                 metric="charged LJ/Coulomb melt + fix bfield 200 T, NVE, "
                        "f32"),
    "lj": dict(steps=500, reps=3, warmup=300, nvt=False,
               metric="LJ melt bench/in.lj, NVE, f32"),
    "monolayer": dict(steps=100, reps=3, warmup=100, nvt=True,
                      metric="MoS2 monolayer REBOMOS NVT 300K, f32"),
}


def loops_main(args, name):
    """The workload through both loops, each on its own Engine, windows in
    turns."""
    import torch
    w = WORKLOADS[name]
    dev = torch.device("cuda:0")

    def conserved(eng):
        row = eng._thermo(eng.state)
        e = row["pe"] + row["ke"]
        if w["nvt"]:
            e += float(eng.fixes[0].energy(eng.state, eng.ctx))
        return e

    import chip_smoke as cs
    make = {"aeam": lambda f: cs.aeam_engine(dev, f, poly_mode=args.poly),
            "melt": lambda f: cs.deck_engine(dev, "melt", f),
            "lj": lambda f: cs.deck_engine(dev, "lj", f),
            "monolayer": lambda f: cs.mono_engine(dev, f)}[name]
    torch.cuda.reset_peak_memory_stats()
    engines = {"graph": make(None), "eager": make(False)}
    natoms = engines["graph"].state.natoms
    out = {}
    for loop, eng in engines.items():
        t0 = time.perf_counter()
        eng.rebuild_neighbors()
        pe, _ = eng.evaluate()
        eng.run(w["warmup"])
        torch.cuda.synchronize()
        out[loop] = dict(
            metric=f"atom-steps/sec/chip ({w['metric']}, {loop} loop)",
            unit="atom-steps/s", windows=[], pe_per_atom=float(pe) / natoms,
            warmup_s=time.perf_counter() - t0, e0=conserved(eng),
            s0=eng.state.step)
    names = list(engines)
    for rep in range(args.reps):
        for loop in (names if rep % 2 == 0 else names[::-1]):
            eng = engines[loop]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run(args.steps)
            torch.cuda.synchronize()
            rate = natoms * args.steps / (time.perf_counter() - t0)
            out[loop]["windows"].append(rate)
            print(f"# {loop}: {rate:.6g} atom-steps/s", file=sys.stderr,
                  flush=True)
    for loop, eng in engines.items():
        o = out[loop]
        o["value"] = max(o["windows"])
        o["median"] = statistics.median(o["windows"])
        o["drift_per_step_atom"] = abs(conserved(eng) - o.pop("e0")) / (
            eng.state.step - o.pop("s0")) / natoms
        o["K"] = dict(eng._plan.k_caps)
        o["ghosts"] = eng.nbr.ghosts.count
        o["rebuilds"] = eng.rebuilds
        secs = dict(eng.timers.acc)
        # the sections' sum (a dotted key is a part of its section)
        tot = sum(v for k, v in secs.items() if "." not in k) or 1.0
        o["timers"] = {k: [v, v / tot] for k, v in secs.items()}
    print(json.dumps(dict(
        workload=name, natoms=natoms, poly_mode=args.poly,
        window_steps=args.steps, loops=out,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        gpu=gpu_name())), flush=True)


#: the sharded workloads: grid (None: config 5), steps a window, windows
SHARDED = {"2x2": dict(grid=(2, 2), steps=300, reps=3),
           "slabs": dict(grid=(4, 1), steps=300, reps=3),
           "config5": dict(grid=None, steps=100, reps=3)}


def sharded_main(args):
    """The sharded engine of --sharded in --placement (chip_smoke's
    shard_bench / scale_engine), windows in turns with the single Engine
    for the bench-scene layouts."""
    import torch
    import chip_smoke as cs
    w = SHARDED[args.sharded]
    dev = torch.device("cuda:0")
    kw = dict(placement=args.placement)
    n = 8 if w["grid"] is None else w["grid"][0] * w["grid"][1]
    if args.placement == "per_device":
        kw["devices"] = cs.card_devices(n)
    torch.cuda.reset_peak_memory_stats()
    engines = {}
    if w["grid"] is None:
        engines["sharded"] = cs.scale_engine(dev, **kw)
    else:
        engines["sharded"] = cs.shard_bench(dev, w["grid"], **kw)
        engines["single"] = cs.bench_engine(dev)
    natoms = engines["sharded"].natoms
    for eng in engines.values():
        t0 = time.perf_counter()
        eng.run(w["steps"])
        cs.sync_all()
        print(f"# warm-up: {w['steps']} steps in "
              f"{time.perf_counter() - t0:.2f} s", file=sys.stderr, flush=True)
    rates = cs.windows_in_turns(engines, steps=args.steps, reps=args.reps)
    se = engines["sharded"]
    print(json.dumps(dict(
        metric=f"atom-steps/s (MoS2 REBOMOS NVE, {natoms} atoms, f32, "
               f"sharded {args.sharded}, {args.placement})",
        unit="atom-steps/s", value=max(rates["sharded"]),
        median=statistics.median(rates["sharded"]), windows=rates,
        window_steps=args.steps, natoms=natoms,
        devices=[str(d) for d in se.group.devices]
        if args.placement == "per_device" else [str(dev)] * n,
        resettles=se.resettles, n_cap=se.n_cap, k_caps=dict(se._plan.k_caps),
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        gpu=gpu_name())), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=None,
                    help="steps a window (1000; the workloads' own below)")
    ap.add_argument("--reps", type=int, default=None,
                    help="windows (5; 3 each loop for the workloads)")
    ap.add_argument("--drift-steps", type=int, default=2000)
    ap.add_argument("--eager", action="store_true",
                    help="the host loop instead of the graph loop")
    for name, what in (("aeam", "benchmarks/bench_aeam.py's workload"),
                       ("melt", "config 2, the 65,536-ion charged melt"),
                       ("lj", "LAMMPS's bench/in.lj, 32,000 atoms"),
                       ("monolayer", "config 4, the 1,000,518-atom "
                                     "monolayer")):
        ap.add_argument(f"--{name}", action="store_true",
                        help=f"{what}, both loops")
    ap.add_argument("--poly", action="store_true",
                    help="with --aeam: poly_mode, not the table splines")
    ap.add_argument("--sharded", choices=tuple(SHARDED), default="",
                    help="the sharded engine on the bench scene (2x2, "
                         "slabs) or config 5")
    ap.add_argument("--placement", choices=("stacked", "per_device"),
                    default="stacked", help="with --sharded")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_bench: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.sharded:
        args.steps = args.steps or SHARDED[args.sharded]["steps"]
        args.reps = args.reps or SHARDED[args.sharded]["reps"]
        return sharded_main(args)
    for name, w in WORKLOADS.items():
        if getattr(args, name):
            args.steps = args.steps or w["steps"]
            args.reps = args.reps or w["reps"]
            return loops_main(args, name)
    args.steps = args.steps or 1000
    args.reps = args.reps or 5
    import chip_smoke as cs
    dev = torch.device("cuda:0")
    eng = cs.bench_engine(dev)
    if args.eager:
        eng.fused_loop = False
    natoms = eng.state.natoms
    loop = "eager" if args.eager else "graph"
    result = {"metric": f"atom-steps/s (MoS2 REBOMOS NVE, {natoms} atoms, "
                        f"f32, {loop} loop)",
              "value": 0.0, "unit": "atom-steps/s", "vs_baseline": 0.0}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.run(100)
    torch.cuda.synchronize()
    print(f"# warm-up: 100 steps in {time.perf_counter() - t0:.2f} s "
          f"(plan, kernel build, capture)", file=sys.stderr, flush=True)

    def etotal():
        return eng._thermo(eng.state)["etotal"]

    e_start, s_start = etotal(), eng.state.step
    rates, rebuilds = [], []
    for _ in range(args.reps):
        rb0 = eng.rebuilds
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(args.steps)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates.append(natoms * args.steps / dt)
        rebuilds.append(eng.rebuilds - rb0)
        print(f"# {args.steps} steps in {dt:.3f} s -> {rates[-1]:.6g} "
              f"atom-steps/s, {rebuilds[-1]} rebuilds", file=sys.stderr,
              flush=True)
    best = max(rates)
    result["value"] = best
    result["vs_baseline"] = best / BASELINE
    extra = max(0, args.drift_steps - (eng.state.step - s_start))
    extra += -extra % eng.check_every
    if extra:
        eng.run(extra)
    e_end = etotal()
    horizon = eng.state.step - s_start
    drift = abs(e_end - e_start) / horizon / natoms
    err, rms = f32_force_error(dev)
    gpu = gpu_name()
    result.update({
        "median": statistics.median(rates), "windows": rates,
        "window_steps": args.steps, "window_rebuilds": rebuilds,
        "f32_etotal_drift_ev_per_step_atom": drift,
        "f32_drift_horizon_steps": horizon,
        "f32_drift_within_1e-6_bound": bool(drift < 1e-6),
        "f32_max_force_err": err, "f32_force_rms": rms,
        "f32_max_force_err_over_rms": err / rms,
        "f32_force_within_1e-2_rms_bound": bool(err < 1e-2 * rms),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "k_caps": dict(eng._plan.k_caps), "gpu": gpu})
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
