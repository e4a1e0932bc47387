#!/usr/bin/env python3
"""Where the time of a step goes: the PyTorch/CUDA port's bench scene on
one NVIDIA GPU.

    python3 tools/torch_step_profile.py [TREE] [--label NAME] [--trace PATH]
        [--lj full|half] [--combine mirror|rows|pin|pin2|react] [--sort]
        [--no-react-gate] [--eager] [--aeam [--poly]]
        [--deck melt|lj|monolayer|wide_melt]

TREE (default: this repository) holds chip_smoke.py and
lammps_plugins_tpu_torch/; giving a second tree (for example a `git
archive` of the parent commit) compares two versions on one card.  The
force configuration is REBOMoS's (lj=, combine=, react_gate=), the scene
spatially sorted with --sort (combine=react needs it); the defaults are
the main path, and a tree older than these options takes only the
defaults.  Engine.run takes the Engine's default loop (on the card the
device loop's CUDA graphs, for a tree that has them); --eager sets
fused_loop = False (the host loop).  --aeam profiles the AEAM sample.in
step instead (chip_smoke.aeam_engine: 32,000 atoms, NVT 863 K, skin 1.2,
check every 12; --poly for poly_mode), with a 288-step warm-up.  --deck
profiles another main path of chip_smoke.py: melt (phase 7, the
65,536-ion charged melt with fix bfield), lj (phase 7, bench/in.lj,
32,000 atoms), monolayer (phase 8, 1,000,518 atoms; 100-step windows) or
wide_melt (phase 11, the melt with lj/cut/coul/cut 6 12 at skin 2;
300-step windows).
After
100 warm-up steps of the 97,920-atom scene (chip_smoke.bench_engine) it
measures

  * atom-steps/s of 3 runs of 1,000 steps with their rebuild counts,
  * host-clock ms per rebuild (5 reps), and torch.profiler over 3 more
    rebuilds: device ms per rebuild and its kernels by device time (the
    rebuild's breakdown; every gather kernel listed by name),
  * host-clock ms per step without a rebuild (3 reps of 10 segments of
    check_every steps), then torch.profiler device time per step over 10
    more such segments,
  * torch.profiler over 200 steps (240 with --aeam) of Engine.run: the
    kernels by device time (printed table and, per step, in the RESULT
    line; Chrome trace to --trace when given),

and prints one line `RESULT {json}` with the card's name and power limit.

    python3 tools/torch_step_profile.py --sharded 2x2|slabs|config5

profiles the sharded step instead, in one call for three engines one
after the other: the single-device Engine on the same scene, the sharded
engine stacked on cuda:0, and per device (one stream a shard, over
min(count, 4) cards), each from chip_smoke.py (bench_engine, shard_bench,
scale_engine; config 5's single Engine is the 7,999,488 atoms unsharded,
reported as refused where it does not fit the card).  After a warm-up of
100 steps each, torch.profiler over 100 steps of Engine.run: every
kernel's device ms a step and launches a step, the device ms a step, the
host launch calls and graph launches a step, and wall ms a step (host
clock, the same steps unprofiled).
One line `RESULT {json}`.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import time


def sharded_main(args, cs, gpu):
    """--sharded: the single Engine, stacked and per-device placements of
    one layout profiled one after the other (module docstring)."""
    import gc
    import torch
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda:0")
    steps = 100
    grid = {"2x2": (2, 2), "slabs": (4, 1), "config5": None}[args.sharded]
    n = 8 if grid is None else grid[0] * grid[1]

    def single():
        if grid is not None:
            return cs.bench_engine(dev)
        from lammps_plugins_tpu_torch.core import units
        from lammps_plugins_tpu_torch.fixes.nve import FixNVE
        from lammps_plugins_tpu_torch.run.simulation import Engine
        se = cs.scale_engine(dev)
        st, pair = se.to_state(), se.pair
        del se
        return Engine(st, pair, [FixNVE()], units.METAL,
                      skin=cs.SCALE_8M["skin"],
                      check_every=cs.BENCH["check_every"])

    def sharded(placement):
        kw = dict(placement=placement)
        if placement == "per_device":
            kw["devices"] = cs.card_devices(n)
        if grid is None:
            return cs.scale_engine(dev, **kw)
        return cs.shard_bench(dev, grid, **kw)

    out = {}
    for name, make in (("single", single),
                       ("stacked", lambda: sharded("stacked")),
                       ("per_device", lambda: sharded("per_device"))):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            eng = make()
            eng.run(100)
            cs.sync_all()
        except torch.cuda.OutOfMemoryError as e:
            out[name] = dict(refused=str(e).splitlines()[0][:200],
                             peak_gib=torch.cuda.max_memory_allocated()
                             / 2 ** 30)
            eng = None
            continue
        natoms = eng.natoms if hasattr(eng, "natoms") else eng.state.natoms
        cs.sync_all()
        t0 = time.perf_counter()
        eng.run(steps)
        cs.sync_all()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.run(steps)
            cs.sync_all()
        cuda = torch.autograd.DeviceType.CUDA
        ops = [e for e in prof.events() if e.device_type == cuda]
        calls = collections.Counter(e.name for e in prof.events()
                                    if e.device_type != cuda
                                    and e.name.startswith("cu"))
        dev_ms = sum(e.time_range.elapsed_us() for e in ops) / steps / 1e3
        by = collections.defaultdict(lambda: [0.0, 0])
        for e in ops:
            by[e.name[:120]][0] += e.time_range.elapsed_us() / steps / 1e3
            by[e.name[:120]][1] += 1
        out[name] = dict(
            natoms=natoms, wall_ms_per_step=wall_ms,
            device_ms_per_step=dev_ms,
            host_launch_calls_per_step=sum(calls[c] for c in cs.LAUNCH_CALLS)
            / steps,
            graph_launches_per_step=calls["cudaGraphLaunch"] / steps,
            atom_steps_per_s=natoms / (wall_ms * 1e-3),
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            kernels_ms_per_step=[[k, ms, c / steps] for k, (ms, c) in sorted(
                by.items(), key=lambda kv: -kv[1][0])][:30])
        print(f"{name}: {wall_ms:.4f} ms a step, device {dev_ms:.4f} ms, "
              f"host launch calls a step "
              f"{out[name]['host_launch_calls_per_step']:.2f}", flush=True)
        if hasattr(eng, "close"):
            eng.close()
        del eng
    print("RESULT " + json.dumps(dict(label=args.label, sharded=args.sharded,
                                      steps=steps, engines=out, gpu=gpu)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tree", nargs="?", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--trace", default="")
    ap.add_argument("--lj", default="full", choices=("full", "half"))
    ap.add_argument("--combine", default="mirror",
                    choices=("mirror", "rows", "pin", "pin2", "react"))
    ap.add_argument("--sort", action="store_true")
    ap.add_argument("--no-react-gate", action="store_true")
    ap.add_argument("--eager", action="store_true")
    ap.add_argument("--aeam", action="store_true")
    ap.add_argument("--poly", action="store_true")
    ap.add_argument("--deck", default="",
                    choices=("", "melt", "lj", "monolayer", "wide_melt"))
    ap.add_argument("--sharded", default="",
                    choices=("", "2x2", "slabs", "config5"))
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    if os.path.dirname(os.path.abspath(cs.__file__)) != tree:
        raise SystemExit(f"chip_smoke.py was not imported from {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("torch_step_profile: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    if args.sharded:
        return sharded_main(args, cs, subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
    config = {}
    if args.lj != "full":
        config["lj"] = args.lj
    if args.combine != "mirror":
        config["combine"] = args.combine
    if args.no_react_gate:
        config["react_gate"] = False
    if args.sort:
        config["sort"] = True
    if args.aeam:
        config = dict(aeam=True, poly_mode=args.poly)
        eng = cs.aeam_engine(dev, poly_mode=args.poly)
    elif args.deck:
        config = dict(deck=args.deck)
        if args.deck == "monolayer":
            eng = cs.mono_engine(dev)
        elif args.deck == "wide_melt":
            eng = cs.wide_melt(cs.DECKS["melt"], device=dev).engine()
        else:
            eng = cs.deck_engine(dev, args.deck)
    else:
        eng = cs.bench_engine(dev, **config)
    if args.eager:
        eng.fused_loop = False
    natoms, seg = eng.state.natoms, eng.check_every
    eng.run(288 if args.aeam else 100)
    torch.cuda.synchronize()

    def clock(fn, reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    def segment():
        eng._segment(eng.state, eng.nbr, seg)

    profiled = 240 if args.aeam else 200
    runs = []
    # a multiple of check_every
    window = (1008 if args.aeam else 100 if args.deck == "monolayer"
              else 300 if args.deck == "wide_melt" else 1000)
    for _ in range(3):
        rb0 = eng.rebuilds
        ms = clock(lambda: eng.run(window), 1)
        runs.append((natoms * window / (ms * 1e-3), eng.rebuilds - rb0))
    rebuild_ms = [clock(eng.rebuild_neighbors, 1) for _ in range(5)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            eng.rebuild_neighbors()
        torch.cuda.synchronize()
    rebuild_ops = sorted(
        ([e.key, e.self_device_time_total / 3e3, e.count / 3]
         for e in prof.key_averages() if e.self_device_time_total > 0),
        key=lambda r: -r[1])
    print("rebuild, device ms per rebuild by kernel:")
    for name, ms, count in rebuild_ops[:25]:
        print(f"  {ms:9.4f} ms  x{count:5.1f}  {name[:110]}")
    # wall and device time of the same plan (K), back to back
    segment()
    step_ms = [clock(segment, 10) / seg for _ in range(3)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            segment()
        torch.cuda.synchronize()
    dev_ms = sum(e.self_device_time_total
                 for e in prof.key_averages()) / (10 * seg) / 1e3
    rb0 = eng.rebuilds
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run(profiled)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    print(ka.table(sort_by="self_cuda_time_total", row_limit=25,
                   max_name_column_width=60))
    kernels = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print("RESULT " + json.dumps(dict(
        label=args.label, config=config, natoms=natoms,
        loop="eager" if args.eager else "default",
        k_caps=dict(eng._plan.k_caps),
        step_ms_no_rebuild=step_ms, rebuild_ms=rebuild_ms,
        rebuild_device_ms=sum(r[1] for r in rebuild_ops),
        rebuild_ops=[[n[:120], ms, c] for n, ms, c in rebuild_ops[:25]],
        rebuild_gathers={n[:120]: ms for n, ms, _ in rebuild_ops
                         if "gather" in n.lower()},
        run1000_atom_steps_per_s=[r for r, _ in runs],
        run1000_rebuilds=[n for _, n in runs],
        run1000_median=statistics.median(r for r, _ in runs),
        device_ms_per_step_no_rebuild=dev_ms,
        profiled_steps=dict(steps=profiled, rebuilds=eng.rebuilds - rb0,
                            device_events=kernels,
                            device_events_per_step=kernels / profiled),
        step_kernels_ms_per_step=[
            [e.key[:120], e.self_device_time_total / profiled / 1e3,
             e.count / profiled]
            for e in sorted(ka, key=lambda e: -e.self_device_time_total)
            if e.self_device_time_total > 0][:30],
        gpu=gpu)))


if __name__ == "__main__":
    main()
