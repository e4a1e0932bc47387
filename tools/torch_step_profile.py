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
    more such segments, and the idle share 1 - device / wall,
  * torch.profiler over 200 steps (240 with --aeam) of Engine.run: the
    kernels by device time (printed table and, per step, in the RESULT
    line; Chrome trace to --trace when given),

and prints one line `RESULT {json}` with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


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
        idle_share_no_rebuild=[1 - dev_ms / s for s in step_ms],
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
