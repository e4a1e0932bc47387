#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (lammps_plugins_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--golden-rebo PATH_TO_MoS.REBO.set5b]
                          [--prev-tree PATH]

Phases (any failure raises, so the script exits non-zero):
  0. toolchain report; TF32 off; nvcc build of csrc/*.cu for sm_90a
  1. each CUDA kernel against its plain-PyTorch twin at the bench scene's
     shapes (97,920 atoms, REBO K and the cell/candidate widths from the
     rebuild plan; the reaction combine on the route tables of the
     spatially sorted scene): max error against the JAX suite's bars,
     median times, the bound (the least time of the same work on the
     card, `bound`) and, for select_k and the pin copy, the one PyTorch
     call that computes the same function (torch.topk, clone()); the
     histogram of live REBO edges per atom (n, the slots the REBO kernel
     works on); for the LJ sweeps the slot pairs they test after culling,
     reckoned with their own rule, beside the pairs inside the LJ window
     and the first design's count; the rebuild's fused candidate selection
     (D') on the arguments of the bench rebuild, exact against its twin and
     against the unfused path (torch-built keys, then kernel D), in turns
     with it (unfused_ms) and split into its parts (split_ms:
     candidates_split); kernel C also with its virial rows (with_virial:
     the launch of a thermo row and of stress/atom), within 2e-4 x their
     scale of the twin's, its forces and energy row equal to the
     with_energy launch's bit for bit; the reaction combine also against
     the route tables' twin; with --prev-tree (a tree holding an earlier
     lammps_plugins_tpu_torch/, e.g. a `git archive` of the parent commit)
     the LJ sweeps, select-k, D' (also split, and on every later path's
     rebuild: candidates_record) and the reaction combine of that tree's
     build are timed in turns with this one's (prev_design_ms), D''s lists
     must equal that build's and the reaction combine's forces too, bit
     for bit
  2. f32 forces of the 288-atom scene on the card (device rebuild +
     kernels) against the float64 CPU twin forces: max|dF| < 1e-2 RMS(F)
  3. the main path: Engine.run on the 97,920-atom scene (f32, skin 0.8,
     check every 10 steps, 300 K from seed 12345) through the device
     loop's CUDA graphs (the default on the card: the rebuild under a
     conditional node, one host read per span), with every launch counter
     reset first (the wrappers count graph replays); asserts that each
     kernel launched, that the thermo is finite, the NVE drift < 1e-6
     eV/step/atom, and that x, v, f, image and the rebuild count after the
     300 steps equal an eager Engine's (fused_loop=False) from the same
     start bit for bit; then the graph and the eager loop in turns: three
     timed 1,000-step windows each (atom-steps/s, wall ms per step), one
     torch.profiler run of 300 steps each (device ops, host launch calls
     and host syncs, device ms per step; A, B, C and
     D' must show by name in the graph loop's profile), host-clock ms per
     rebuild, the peak memory (line `LOOPS {json}`); then the REBO kernel
     against its twin again on the run's own lists at the run's K
  4. (run last, after phase 11: see main()) the other force
     configurations at the same width, each its own
     Engine through the graph loop: lj="half" with combine="rows",
     combine="react" on the spatially sorted scene (gate off),
     combine="pin", combine="pin2".  Each: step-0
     forces within 3e-4 x scale of the default configuration's on the
     same state, then with the counters reset 300 steps in which each of
     its kernels launches and no kernel it replaces does, finite thermo,
     NVE drift < 1e-6 eV/step/atom; then one timed 1,000-step run
  5. golden thermo rows of in.rebomos-bulk, only when --golden-rebo names
     the published MoS.REBO.set5b (not in the repository)
  6. AEAM sample.in: pair_style aeam with fix nvt on the 32,000-atom Al-Si
     scene of USER-AEAM/sample.in (alsi_sample(nc=20), f32, 863 K from
     velocity_create(seed 4928459), FixNVT(863, 863, 0.1), skin 1.2, a
     displacement check every 12 steps: benchmarks/bench_aeam.py's
     settings).  The candidate selection D' on the AEAM rebuild's own
     arguments at its K (past 128) and at K = 224 and 256, exact against its
     twin, with its median time, bound and launches, and select-k on
     synthetic rows of up to 256 hits at K = 224 and 256; f32 forces of the
     jiggled nc=6 scene with 5 % Si on the card against the f64 CPU twin,
     max|dF| < 1e-2 RMS(F), for the exact spline path and poly_mode; then
     the main path: Engine.run through the graph loop with every launch
     counter reset first (D' must launch, and no other kernel), finite
     thermo, and after 288 steps x, v, f, image, the Nose-Hoover chain and
     the rebuild count equal to an eager Engine's bit for bit; printed as
     `AEAM {json}`: K, the NVT conserved quantity's drift (pe + ke +
     FixNVT.energy, eV/step/atom), the mean T of the last 96 steps, three
     timed windows each of the graph and the eager loop (atom-steps/s),
     device ms and host launch calls per step from one profiled run, the
     peak memory
  7. config 2 and the LJ styles (`BFIELD {json}`): the cyclotron oracle of
     tests/test_fixes.py in f32 through the graph loop (4,096 free ions,
     pair_style none, fix bfield 0 0 1000 T, one period of 2,000 steps;
     every ion back within the oracle's bars, D' the only kernel, then D'
     on a rebuild of the run, whose rows have no hits, exact against its
     twin); f32 forces of the jiggled charged_melt(6) and
     lj_melt(6) on the card against the f64 CPU path, max|dF| < 1e-2
     RMS(F); kernel I (lj/cut forces from each atom's own list row) on
     the jiggled lj_melt(20) and lj_melt(60) (32,000 and 864,000 atoms):
     one launch, against its twin and the edge sweep plus mirror combine
     (ljcut_kernel_record's bars), a rerun bit for bit, median times of
     the three in turns and the bound; then two main paths, the 65,536-ion
     charged melt (tests/test_ljcut.py's CHARGED_MELT deck at n = 32:
     lj/cut/coul/cut 6 / 8, fix bfield 0 0 200 T, fix nve, skin 1.0) and
     LAMMPS's bench/in.lj (lj_melt(20), 32,000 atoms): 300 steps through the
     graph loop with the counters reset (D' and kernel I must launch, no
     other kernel), finite thermo and bfield output, x, v, f, image, every
     extras tensor and the rebuild count equal to an eager Engine's bit for
     bit, both loops' numbers in turns (three 300-step windows each, one
     profiled run), the NVE drift (reported, no bar: the Coulomb cut at 8 A
     and the unshifted LJ cut are energy steps), the forces' device time on
     the run's lists, and D' on a rebuild of the run against its twin
  8. config 4, the MoS2 monolayer (`MONOLAYER {json}`): 1,000,518 atoms
     (rebomos_monolayer(577, 578)), REBOMOS NVT 300 K from seed 12345,
     skin 0.8, check every 10: 100 steps through the graph loop with the
     counters reset (A, B, C and D' must launch), the NVT conserved
     quantity's drift < 1e-6 eV/step/atom, A and B against their twins on
     the run's own lists at its K, C (and its virial rows) against its
     twin on the run's own cell grid (mostly empty in z), the state equal
     to an eager Engine's bit for bit (the chain included), both loops'
     numbers (three 100-step windows each), the peak memory, K and the
     ghost count, D' against its twin and the rebuild's device time at
     this size

  9. decks through the port's input-script interpreter (`SCRIPT {json}`),
     api/script.py's Script on the card with its defaults:
     (a) the in.rebomos-bulk deck text (lattice custom with $(...) basis,
     the tilted prism) replicated 17 4 5 to 97,920 atoms, 300 K from seed
     12345, skin 0.8, with compute pe/atom and stress/atom NULL, a custom
     dump every 250 steps and a restart file every 500, run 1000 through
     the graph loop with the counters reset (A, B, C and D' must launch;
     C's energy row once in each frame's pe/atom): Σ pe/atom within 1e-5
     of the frame's pe, the pressure of Σ vatom within 5e-5 of the
     pressure tensor's scale (PRESS_BAR), pe/atom and the six stress/atom
     columns atom by atom within 1e-4 and 5e-4 of their scale of the same
     code run on the frame's card tensors with A, B and C swapped for
     their twins (plain_kernels), a second run writing the same
     dump bytes and thermo rows, the same deck without its output lines
     giving the same thermo rows bit for bit, read_restart of the step-500 file plus 10
     steps within 1e-3 A of the uninterrupted run; every thermo row of the
     first run (REBOMoS.energy_virial: kernels A and C once each under
     no_grad) held to the strain autograd on the same card tensors (pe
     2e-5 relative, W 5e-4 x max|W|); atom-steps/s with and
     without the outputs, ms per dump frame (per-atom computes, host
     copy, text), ms of a thermo row beside the autograd row it replaced,
     of stress/atom and of the row's C launch, peak memory; then this
     slice's path counted alone (a thermo row and a stress/atom frame with
     every twin and torch.autograd.grad refused: A, B and C launch) and
     energy_virial with A, B and C swapped for their twins (no launch,
     the same pe and W); (b) sample.in at full width (32,000 atoms,
     phase 6's settings through `neigh_modify every 12`): 96 steps equal to
     phase 6's Engine bit for bit (D' must launch); then the deck with
     `fix nvt temp 863 900 0.1` run twice for 96 steps: the end points
     stay, each run re-anchors the window, the second window recaptures
     the graph, and the state equals the eager loop's bit for bit, and
     the ms of one thermo row (the strain autograd AEAM keeps); (c)
     bench/in.lj (32,000
     atoms) read from a data file of the lattice moved by 0.05 sigma: FIRE
     on the card (MinResult, ms per iteration), then fix langevin + fix
     nve for 300 steps, graph loop = eager loop bit for bit, the noise
     drawn on the card at three steps = the CPU draw, D' and kernel I
     launched; then the Langevin step's graph loop in turns with in.lj's
     plain NVE step (three 500-step windows each, capture excluded) and
     the device time
     of one noise draw replayed alone in a graph, and the ms of one
     thermo row (lj/cut's strain autograd)

  10. the sharded engine with its shards stacked on the card (`SHARDED
     {json}`, lammps_plugins_tpu_torch/parallel/): (a) the bench scene in
     a 2x2 grid and in four x-slabs on devices=[card] * 4: pe and forces
     of a copy jiggled by 0.05 A against the single-device Engine (2e-5
     relative, 3e-4 x scale), its thermo row too (A and C once a shard,
     every twin and autograd refused; pe 2e-5 relative, the pressure
     tensor 5e-4 of its scale), A, B, C and D' against their twins on shard
     0's own block, lists and cells (pad and halo rows, a slab box
     non-periodic in x; D' exact, its pad rows skipped), 300 steps
     through the sharded graph loop (every shard's resettle under the
     conditional node) with the counters reset (A, B, C and D' must
     launch), the NVE drift, the thermo rows at steps 100, 200 and 300
     against the single-device run's (SHARD_ROW_BARS), the atoms that
     changed shard (> 0), the state after 300 steps equal to the eager
     host loop's bit for bit (rows, layout, halo tables, resettles), then
     atom-steps/s in turns with the single-device Engine's graph loop,
     host launch calls and device ms a step from a profiled run, a
     resettle's device ms and its top device ops, the peak memory; (b)
     config 2 (65,536 ions) in four x-slabs for 100 steps: fix bfield's
     fsum and the rows against the single-device run (FSUM_BAR,
     MELT_ROW_BARS), graph = eager bit for bit with the fix's extras; (c)
     config 5, benchmarks/scale_multichip.py's 7,999,488-atom bulk
     (rebomos_bulk_commensurate(1302, 64, 16)) in eight x-slabs, skin 1.0:
     pe/atom at step 0 against the bench scene's (1e-5), 100 steps through
     the graph loop (A, B, C and D' must launch), the NVE drift, a second
     100-step window's atom-steps/s, per-shard capacities and ghosts, the
     peak memory, a thermo row's ms and its own peak; (d) the phase-9
     REBOMOS deck without outputs through
     Script(n_devices=4, devices=[card] * 4) for 200 steps, its thermo
     rows against the single-device Script's (SHARD_ROW_BARS); (e) the
     entry checks of lammps_plugins_tpu_torch/entry.py with their
     defaults (the card, float32): entry() and dryrun_multichip(4); (f)
     the per-device placement (parallel/per_device.py), a stream a shard
     on the card: a child process asks the card whether one shard's
     capture may wait on another's event (the design question of its
     graphs); config 5 per device (100 steps through the captured pieces,
     pe/atom, drift, atom-steps/s beside (c)'s, the peak; a config that
     does not fit is reported with the memory it reached and a shorter
     one run); the bench scene's two layouts per device for 300 steps
     with resettles: the state, halo tables and thermo rows equal to the
     stacked layout's and to the placement's own eager run bit for bit,
     A, B, C and D' launched by every shard, atom-steps/s in turns with
     the stacked layout, host launch calls, graph launches and device ms
     a step from profiled runs of both; config 2 per device against the
     stacked layout (the trajectory bit for bit, fsum within FSUM_BAR,
     rows within MELT_ROW_BARS, graph = eager, D' on every shard); the
     [card, cpu] pair of two x-slabs (the 864-atom scene in f32, step-0
     pe and forces against the stacked layout on the card at
     SHARD_PE_BAR, SHARD_F_BAR, then eager steps); with several cards
     the bench scene over min(count, 4) of them, else one line saying
     that it did not run

  11. lists past the card's former size limits (`WIDE {json}`): (a) the
     wide-cut melt, config 2's 65,536-ion deck with lj/cut/coul/cut 6 12
     and LAMMPS's default metal skin of 2 A (wide_melt), 300 steps
     through the graph loop with the counters reset: K past 256 at every
     thermo row (K's trajectory printed), D' and kernel I launched (no
     other kernel), finite thermo, the state equal to an eager Engine's bit
     for bit, both loops' 300-step windows in turns with a profiled run and
     the peak memory, then D' on a rebuild of the run exact against its twin
     (median time, bound, launches); (b) f32 forces of the jiggled
     1,024-ion copy of the deck against the f64 CPU path, max|dF| < 1e-2
     RMS(F); (c) the bench scene at skin 4.0, 100 steps through the graph
     loop: the REBO list's K past 64, A, B, C and D' launched, the NVE
     drift < 1e-6 eV/step/atom, graph = eager bit for bit, A on the run's
     planes within 5e-4 x scale of its twin (the twin REBO_TWIN_ATOMS
     atoms at a time), D' on a rebuild of the run; (d) kernel-only checks,
     each exact against its twin: D' on lj_melt(12) with lj/cut 7.0 (6,912
     atoms, K past 1,024, its cells too large to stage, read in place), D'
     on a 21-type lj/cut mixture with a cut per type pair, and D on seeded rows
     of 0, K / 2, K, 3K, K + 17 tied and 3K tied hits at K = 320, 512 and
     1024 and W = 2048 and 4096

The REBOMOS parameters are the synthetic file tests/data/MoS.REBO.synthetic,
the AEAM ones tests/data/AlSi.synthetic.aeam.
Output ends with a JSON line of per-kernel results, the card's name and
power limit (nvidia-smi), and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
REBO_FILE = os.path.join(REPO, "tests", "data", "MoS.REBO.synthetic")
AEAM_FILE = os.path.join(REPO, "tests", "data", "AlSi.synthetic.aeam")
#: benchmarks/bench_aeam.py's settings (sample.in at nc=20: 32,000 atoms)
AEAM = dict(nc=20, skin=1.2, check_every=12, temp=863.0, seed=4928459,
            t_damp=0.1)
AEAM_RUN_STEPS = (192, 96)      # then thermo every 12 over the last 96
AEAM_TIMED_STEPS = 480
AEAM_PROFILE_STEPS = 96
BENCH = dict(nx=34, ny=48, nz=10, skin=0.8, check_every=10, temp=300.0,
             seed=12345)
RUN_STEPS = 300        # at 300 K the list is rebuilt about every 43 steps
TIMED_STEPS = 1000     # a timed window spans ~20 rebuilds
TIMED_REPS = 3
PIN_REPS = 100         # pin copy and clone(), in turns
GOLDEN = [(0, 0.0, -2061.6112), (10, 80.776057, -2064.6132),
          (20, 146.17503, -2067.0428)]     # log.rebomos-bulk.1:54-56


def sh(*cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True,
                          timeout=120).stdout.strip()


#: the H100 SXM rates of the bounds (NVIDIA's data sheet, at 700 W): HBM
#: bytes/s, FP32 flop/s outside the tensor cores, and the special-function
#: units (132 SMs x 16 a clock at the 1.98 GHz boost clock)
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
SFU_OPS = 132 * 16 * 1.98e9


def bound(nbytes, flops, sfu=0.0):
    """(bound_ms, bound_by): the least time the card could take for the
    work, the larger of bytes / HBM rate and operations / peak rate."""
    t_b = nbytes / HBM_BPS
    t_o = max(flops / FP32_FLOPS, sfu / SFU_OPS)
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def rebo_live_counts(planes, consts):
    """n per atom: the slots with w != 0 or w' != 0 (masked in and short
    of rcmax), the edges the REBO kernel works on."""
    dxT, dyT, dzT, jelT, mskT, ei = planes

    def pairc(name):
        a0, a1, b0, b1 = consts["pair:" + name]
        return (a0 + a1 * ei) + (b0 + b1 * ei) * jelT

    r = torch.sqrt(dxT * dxT + dyT * dyT + dzT * dzT)
    t = (r - pairc("rcmin")) * pairc("inv_drc")
    return ((mskT > 0) & (t < 1.0)).sum(dim=0)


def rebo_work(planes, consts):
    """(bytes, flops, sfu ops, histogram of n) of the REBO cotangents:
    five [K, Np] planes and the centre row in, three planes out; ~40 flops
    and 5 special-function ops per live edge, ~100 flops per unordered
    pair of live edges of one atom (cos, g, g' and the two passes'
    sums)."""
    K, Np = planes[0].shape
    n = rebo_live_counts(planes, consts)
    nd = n.double()
    edges, pairs = float(nd.sum()), float((nd * (nd - 1) / 2).sum())
    nbytes = 4 * (5 * K * Np + Np + 64) + 4 * 3 * K * Np
    hist = torch.bincount(n, minlength=K + 1).tolist()
    return nbytes, 40 * edges + 100 * pairs, 5 * edges, hist


def lj_window_pairs(P, consts, a_range):
    """Ordered pairs (owned A atom, any B atom) inside the LJ window: the
    pairs whose forces the LJ sweep must compute."""
    import itertools
    (x0, x1), (y0, y1), (z0, z1) = a_range
    A = P[x0:x1, y0:y1, z0:z1]
    ael = A[..., 3, :, None]
    own = A[..., 4, :, None] > 0
    total = 0
    for ox, oy, oz in itertools.product((-1, 0, 1), repeat=3):
        B = P[x0 + ox:x1 + ox, y0 + oy:y1 + oy, z0 + oz:z1 + oz]
        ebl = B[..., 3, None, :]

        def cst(name):
            a0, a1, b0, b1 = consts[name]
            return (a0 + ael * a1) + (b0 + ael * b1) * ebl

        rsq = sum((A[..., r, :, None] - B[..., r, None, :]) ** 2
                  for r in range(3))
        total += int(((rsq >= cst("ljminsq")) & (rsq <= cst("ljmaxsq"))
                      & own).sum())
    return total


#: spin-kernel cycles queued ahead of each timed call (~0.5 ms at 1.98
#: GHz): the call's launches are enqueued while the card still spins, so
#: the events around them read device time, not the host's time to launch
SPIN_CYCLES = 1_000_000


def device_ms(fn) -> float:
    """Device time of one fn() in ms: CUDA events around it, queued behind
    a spin kernel, then synchronised."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def interleaved_ms(fns, reps):
    """Median device ms of each callable in `fns` (name -> fn): one call
    each per turn, the order reversed every other turn."""
    names = list(fns)
    for name in names:
        fns[name]()
        fns[name]()
    torch.cuda.synchronize()
    times = {name: [] for name in names}
    for rep in range(reps):
        for name in (names if rep % 2 == 0 else names[::-1]):
            times[name].append(device_ms(fns[name]))
    return {name: statistics.median(t) for name, t in times.items()}


def timed_ms(fn, reps=10) -> float:
    """Median device time of fn() in ms."""
    return interleaved_ms({"fn": fn}, reps)["fn"]


def rebuild_device_ms(eng) -> float:
    """Device ms of one rebuild of an Engine's lists at its plan and state
    (run/device_loop.device_seconds around rebuild_lists)."""
    from lammps_plugins_tpu_torch.run.device_loop import device_seconds
    st = eng.state
    return 1e3 * device_seconds(lambda: eng.rebuild_lists(
        eng._plan, st.x, st.image, st.type, eng.pair.neighbor_requests()),
        st.x.device)


@contextlib.contextmanager
def timed(label):
    """Print the wall seconds that the block took (the card synchronised)."""
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    print(f"== {label}: {time.perf_counter() - t0:.1f} s", flush=True)


def phase0_environment():
    from lammps_plugins_tpu_torch.ops import build
    print(f"torch {torch.__version__}")
    print(f"torch.version.cuda {torch.version.cuda}")
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton not installed")
    print(sh(build._nvcc(), "--version").splitlines()[-1])
    print("gpu " + sh("nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.lib()
    print(f"kernels built from {os.path.relpath(build.CSRC, REPO)}/*.cu "
          f"with {' '.join(build.ARCH_FLAGS)} in "
          f"{time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(build.LIB_PATH, REPO)}")
    print(build.build_log, file=sys.stderr)


#: the force configurations of phase 4: name, REBOMoS arguments, scene
#: sorted, and the kernels (launch-counter modules of ops/) it runs.  The
#: react gate is off: on the sorted bench scene with the synthetic
#: parameters the measured route depth KC reaches 13 during the run, past
#: the gate's 12 (a threshold set for the TPU kernel), and the gate would
#: refuse the configuration.
CONFIGS = (
    ("half_rows", dict(lj="half", combine="rows"), False,
     ("rebo", "mirror_rows", "lj_half", "select_candidates")),
    ("react", dict(combine="react", react_gate=False), True,
     ("rebo", "react", "lj_cells", "select_candidates")),
    ("pin", dict(combine="pin"), False, ("rebo", "pin", "lj_cells",
                                         "select_candidates")),
    ("pin2", dict(combine="pin2"), False, ("rebo", "pin", "lj_cells",
                                           "select_candidates")),
)
MAIN_PATH = ("rebo", "mirror", "lj_cells", "select_candidates")
#: the kernels of every lj/cut and lj/cut/coul/cut path
LJ_PATH = ("select_candidates", "ljcut")
#: launch-counter module of ops/ -> kernel name in the JSON line.  The
#: standalone select_k (D) runs on no path since the rebuild fused it with
#: its keys (select_candidates, D'); phase 1 still holds it to its twin.
KERNEL_NAMES = {"rebo": "rebo_cotangents", "mirror": "mirror_combine",
                "lj_cells": "lj_cell_forces", "select_k": "select_k",
                "select_candidates": "select_candidates",
                "lj_half": "lj_cell_forces_half",
                "mirror_rows": "mirror_combine_rows",
                "react": "react_combine", "pin": "pin_copy",
                "ljcut": "ljcut_forces"}


#: the builds D' is split and timed with: "this" (this tree's ops/build.py)
#: and, with --prev-tree, "build" and "tree" of the earlier tree (main)
PREV = {}


def ops_modules():
    import importlib
    return {m: importlib.import_module(f"lammps_plugins_tpu_torch.ops.{m}")
            for m in KERNEL_NAMES}


def load_build(label, tree):
    """The ops/build.py of another tree as a module of its own (it builds
    that tree's csrc/*.cu into the tree's build/ directory)."""
    import importlib.util
    path = os.path.join(tree, "lammps_plugins_tpu_torch", "ops", "build.py")
    spec = importlib.util.spec_from_file_location(f"_build_{label}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lj_launchers(b, P, consts, a_range):
    """{name: fn} launching the LJ sweeps of the build `b` (this tree's
    ops/build.py or another tree's, load_build) on planes P through its
    C entry points, each fn returning its output: "lj_cell_forces",
    "lj_cell_forces+energy" (C) and "lj_cell_forces_half" (E).  The
    arguments follow the build's C signatures: the tile-culling designs
    take a packing scratch and Dx as two trailing arguments, the first
    designs do not."""
    from lammps_plugins_tpu_torch.ops import lj_cells
    lib = b.lib()
    Dx, Dy, Dz, _, C = P.shape
    (x0, x1), (y0, y1), (z0, z1) = a_range
    Ax, Ay, Az = x1 - x0, y1 - y0, z1 - z0
    dev = P.device
    cvec = b.device_constants(
        tuple(v for n in lj_cells.LJ_NAMES for v in consts[n]), dev)
    out_c = torch.empty((Ax, Ay, Az, 8, C), device=dev)
    out_e = torch.empty((Ax, Ay, Az, C, 3), device=dev)
    part = torch.empty((27, Ax * Ay * Az, 3, C), device=dev)
    scratch = torch.empty(lj_cells.scratch_floats(P.shape), device=dev)
    n_args = len(b._SIGNATURES["lpt_lj_cell_forces"])
    extra = (scratch.data_ptr(), Dx) if n_args > 14 else ()
    stream = b.stream(dev)

    def c(energy):
        # a tree with the virial rows takes (with_virial, vir) last
        b.raise_on_error(lib.lpt_lj_cell_forces(
            P.data_ptr(), cvec.data_ptr(), out_c.data_ptr(), Dy, Dz, C, x0,
            y0, z0, Ax, Ay, Az, int(energy), stream, *extra,
            *((0, None) if n_args > 16 else ())), "lj C")
        return out_c

    def e():
        b.raise_on_error(lib.lpt_lj_cell_forces_half(
            P.data_ptr(), cvec.data_ptr(), part.data_ptr(), out_e.data_ptr(),
            Dy, Dz, C, x0, y0, z0, Ax, Ay, Az, stream, *extra), "lj E")
        return out_e
    return {"lj_cell_forces": lambda: c(False),
            "lj_cell_forces+energy": lambda: c(True),
            "lj_cell_forces_half": e}


def select_k_launcher(b, keys, K, payloads):
    """fn() launching select_k (D) of the build `b` on keys [N, W] with two
    float32 payloads, returning (pos, *payloads at pos).  The designs
    that size their hit buffers from K (13 arguments) take this tree's
    plan (ops/select_k.py::select_k_plan); the earlier ones take none,
    and refuse K > 256 or W > 1024 (the fn then raises)."""
    from lammps_plugins_tpu_torch.ops.select_k import select_k_plan
    lib = b.lib()
    N, W = keys.shape
    dev = keys.device
    pos = torch.empty((N, K), dtype=torch.int32, device=dev)
    outs = [torch.empty((N, K), device=dev) for _ in range(2)]
    stream = b.stream(dev)
    plan = (select_k_plan(K)[:2]
            if len(b._SIGNATURES["lpt_select_k"]) == 13 else ())

    def fn():
        b.raise_on_error(lib.lpt_select_k(
            keys.data_ptr(), payloads[0].data_ptr(), payloads[1].data_ptr(),
            2, pos.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(), N, W,
            K, *plan, stream), "select_k")
        return (pos, *outs)
    return fn


def react_launcher(b, g3, rl):
    """fn() launching the reaction combine (G) of the build `b` on the
    cotangent planes g3 with the list rl's tables, returning its [Np, 3]
    forces: the route-scan design (11 arguments) reads the route tables,
    the target-table design the target-major table rtgt."""
    lib = b.lib()
    K, Np = g3[0].shape
    dev = g3[0].device
    out = torch.empty((Np, 3), device=dev)
    stream = b.stream(dev)
    if len(b._SIGNATURES["lpt_react_combine"]) == 11:
        _, NW, KC, _ = rl.route.shape
        tables = (rl.rblocks.data_ptr(), rl.route.data_ptr(), out.data_ptr(),
                  K, Np, NW, KC)
    else:
        tables = (rl.rtgt.data_ptr(), out.data_ptr(), K, Np,
                  rl.rtgt.shape[0])

    def fn():
        b.raise_on_error(lib.lpt_react_combine(
            *(g.data_ptr() for g in g3), *tables, stream), "react_combine")
        return out
    return fn


def cell_block_plan(k, Cf, nt):
    """(warps, cap, cps) of the one-block-a-cell design of D' (the
    earlier design, the C entry point of 20 arguments): the hit buffers of
    ops/select_k.py::hit_capacity, cps of the 27 neighbour cells' Cf
    slots staged at once (24 bytes a slot) beside the buffers and the
    [nt, nt] cut table, all 27 cells first, then the most warps."""
    from lammps_plugins_tpu_torch.ops.select_k import (SMEM_LIMIT,
                                                       buffer_bytes,
                                                       hit_capacity)
    cap = hit_capacity(k)
    for cps in (27, 9, 3, 1):
        for warps in (4, 2, 1):
            if (24 * cps * Cf + buffer_bytes(warps, cap) + 4 * nt * nt
                    + 8 * warps) <= SMEM_LIMIT:
                return warps, cap, cps
    raise ValueError(f"cell_block_plan: k={k}, Cf={Cf}, nt={nt} do not fit")


def cell_block_prepare(dense_f, c3f, fdims, cut):
    """The int32 inputs of the one-block-a-cell design of D': the cell
    table, the owned atoms sorted by fine cell again (rows with a negative
    cell past the last run) with each cell's run start, and the float32
    cutoff table."""
    d0, d1, d2 = (int(d) for d in fdims)
    dev, i32 = c3f.device, torch.int32
    cid = ((c3f[:, 0] * d1 + c3f[:, 1]) * d2 + c3f[:, 2]).to(i32)
    cid = torch.where(torch.all(c3f >= 0, -1), cid,
                      torch.full_like(cid, d0 * d1 * d2))
    scid, order = torch.sort(cid)
    starts = torch.searchsorted(scid, torch.arange(d0 * d1 * d2 + 1,
                                                   dtype=i32, device=dev))
    return (dense_f.to(i32).contiguous(), order.to(i32), starts.to(i32),
            cut.to(device=dev, dtype=torch.float32).contiguous())


def candidates_parts(b, args):
    """{part: fn} of the rebuild's candidate selection of the build `b` on
    the select_candidates arguments `args`, each fn launching only its
    part on inputs made once: for the one-block-a-cell design (the C entry
    point of 20 arguments) "prepare" (the sort of the owned atoms by cell,
    the int32 table), "fills" (the four zero-filled outputs), "kernel" and
    "kmax" (cnt.max()); for the brick design "gather" (the zeroed kmax
    and, without staging, the positions in cell order) and "kernel".
    "wrapper" runs every part in order and returns (idx, jtype, mask,
    kmax); None where the build has no fused kernel (see
    candidates_launcher)."""
    sig = b._SIGNATURES.get("lpt_select_candidates")
    if sig is None or len(sig) not in (20, 25):
        return None
    xt_pad, dense_f, c3f, fdims, cut, K = args[:6]
    dev = xt_pad.device
    lib = b.lib()
    n, m_all, Cf = c3f.shape[0], xt_pad.shape[0] - 1, dense_f.shape[1]
    d0, d1, d2 = fdims
    if len(sig) == 25:
        return brick_parts(b, args)
    plan = cell_block_plan(K, Cf, cut.shape[0])
    stream = b.stream(dev)
    inputs = cell_block_prepare(dense_f, c3f, fdims, cut)

    def fills():
        return ([torch.zeros((n, K), dtype=dt, device=dev)
                 for dt in (torch.int64, torch.int64, torch.bool)]
                + [torch.zeros(n, dtype=torch.int32, device=dev)])
    outs = fills()

    def kernel(ins=inputs, o=outs):
        table, order, starts, cutc = ins
        b.raise_on_error(lib.lpt_select_candidates(
            xt_pad.data_ptr(), table.data_ptr(), order.data_ptr(),
            starts.data_ptr(), cutc.data_ptr(), cut.shape[0],
            *(t.data_ptr() for t in o), d0, d1, d2, Cf, m_all, K, *plan,
            stream), "select_candidates")

    def wrapper():
        ins = cell_block_prepare(dense_f, c3f, fdims, cut)
        o = fills()
        kernel(ins, o)
        return (*o[:3], o[3].max().to(torch.int64))
    return {"prepare": lambda: cell_block_prepare(dense_f, c3f, fdims, cut),
            "fills": fills, "kernel": kernel,
            "kmax": lambda: outs[3].max().to(torch.int64),
            "wrapper": wrapper}


def brick_parts(b, args, plan=None):
    """candidates_parts of the brick design (the C entry point of 25
    arguments), launched with `plan` or this tree's plan
    (ops/select_candidates.py::candidates_plan) on the binning's runs
    args[6]."""
    from lammps_plugins_tpu_torch.ops import select_candidates as sc
    xt_pad, dense_f, c3f, fdims, cut, K = args[:6]
    runs = args[6]
    dev = xt_pad.device
    lib = b.lib()
    n, m_all, Cf = c3f.shape[0], xt_pad.shape[0] - 1, dense_f.shape[1]
    d0, d1, d2 = fdims
    nt = cut.shape[0]
    p = plan or sc.candidates_plan(K, Cf, nt)
    stream = b.stream(dev)

    def gather():
        """the zeroed kmax and, without staging, the positions in cell
        order"""
        xs = None if p.staged else xt_pad.view(torch.complex128).view(
            -1).index_select(0, runs.order)
        return xs, torch.zeros((), dtype=torch.int64, device=dev)
    ins = gather()
    outs = [torch.empty((n, K), dtype=dt, device=dev)
            for dt in (torch.int64, torch.int64, torch.bool)]

    def kernel(ins=ins, o=outs):
        xs, kmax = ins
        b.raise_on_error(lib.lpt_select_candidates(
            xt_pad.data_ptr(), None if xs is None else xs.data_ptr(),
            runs.order.data_ptr(), runs.starts.data_ptr(), cut.data_ptr(),
            runs.origin.data_ptr(), *(t.data_ptr() for t in o),
            kmax.data_ptr(), float(runs.size), nt, d0, d1, d2, Cf, n, m_all,
            K, p.warps, p.cap, int(p.bucket), p.bx, int(p.staged), stream),
            "select_candidates")

    def wrapper():
        g = gather()
        o = [torch.empty((n, K), dtype=dt, device=dev)
             for dt in (torch.int64, torch.int64, torch.bool)]
        kernel(g, o)
        return (*o, g[1])
    return {"gather": gather, "kernel": kernel, "wrapper": wrapper}


def candidates_launcher(b, args):
    """(fn, design) for the rebuild's candidate selection of the build `b`
    on the select_candidates arguments `args`: its fused kernel D' where
    the build has one ("fused": candidates_parts' wrapper), else the keys
    built in torch by this tree's twin and selected by the build's
    select_k ("unfused").  fn() returns (idx, jtype, mask, kmax)."""
    from lammps_plugins_tpu_torch.ops import select_candidates as sc
    if "lpt_select_candidates" not in b._SIGNATURES:
        def select(keys, k, payloads):
            return select_k_launcher(b, keys, k, payloads)()
        return (lambda: sc.select_candidates_ref(*args[:6], select=select),
                "unfused")
    parts = candidates_parts(b, args)
    if parts is None:
        raise RuntimeError("select_candidates: a design before any K "
                           "(refused here)")
    return parts["wrapper"], "fused"


def candidates_split(b, args, reps):
    """Median device ms of each part of candidates_parts(b, args), in
    turns; {} where the build has no fused kernel."""
    parts = candidates_parts(b, args)
    return interleaved_ms(parts, reps) if parts else {}


def rebo_launcher(b, planes, cvec, K, Np):
    """fn() launching the REBO kernel (A) of the build `b` on the [K, Np]
    planes, returning its three planes.  The designs that take any K (16
    arguments) are given this tree's plan (ops/rebo.py::rebo_plan); the
    earlier ones take none and refuse K > 64 (the fn then raises)."""
    from lammps_plugins_tpu_torch.ops.rebo import rebo_plan
    lib = b.lib()
    dev = planes[0].device
    outs = [torch.empty((K, Np), device=dev) for _ in range(3)]
    stream = b.stream(dev)
    plan = (rebo_plan(K)[:2]
            if len(b._SIGNATURES["lpt_rebo_cotangents"]) == 16 else ())
    ptrs = [p.data_ptr() for p in planes]

    def fn():
        b.raise_on_error(lib.lpt_rebo_cotangents(
            *ptrs, cvec.data_ptr(), *(o.data_ptr() for o in outs), None, K,
            Np, *plan, stream), "rebo_cotangents")
        return outs
    return fn


def select_k_keys(dev, N, W):
    """[N, W] candidate-like keys with two payloads (ids, types), seeded:
    quantized so that ties occur, 5 % finite as in a cell window."""
    g = torch.Generator(device=dev).manual_seed(BENCH["seed"])
    keys = torch.round(torch.rand((N, W), generator=g, device=dev)
                       * 21.0 * 64.0) / 64.0
    keys = torch.where(torch.rand((N, W), generator=g, device=dev) < 0.05,
                       keys, torch.full_like(keys, float("inf")))
    ids = torch.randint(0, 2 ** 24, (N, W), generator=g, device=dev).float()
    typ = torch.randint(1, 3, (N, W), generator=g, device=dev).float()
    return keys, ids, typ


def candidate_work(args):
    """(bytes, flops, candidate pairs) of one select_candidates call: its
    inputs (the positions and types, the rows in cell order and each
    cell's run start, the cutoff table) read once and its outputs (idx and
    jtype int64, mask, kmax) written once; ~10 operations (3 sub, 3 mul,
    3 add, 1 compare) per pair of an owned atom and a real atom of its 27
    cells."""
    from lammps_plugins_tpu_torch.ops.select_candidates import (
        neighbour_cells)
    xt_pad, dense_f, c3f, fdims, cut, K = args[:6]
    n, m_all = c3f.shape[0], xt_pad.shape[0] - 1
    ncf = int(np.prod(fdims))
    occ = (dense_f < m_all).sum(dim=1)
    occ[ncf:] = 0
    pairs = float(occ[neighbour_cells(c3f, fdims)].sum())
    nbytes = (16 * (m_all + 1) + 4 * m_all + 4 * (ncf + 1)
              + 4 * cut.numel() + n * K * 17 + 8)
    return nbytes, 10 * pairs, pairs


def capture_candidate_calls(eng, run=None):
    """eng.rebuild_neighbors(), or run(), recording the arguments of every
    select_candidates call of the rebuild (the last is the one whose
    lists the Engine kept; a sharded resettle makes one a shard)."""
    from lammps_plugins_tpu_torch.neighbor import device_build
    calls = []
    real = device_build.select_candidates

    def spy(*args):
        calls.append(args)
        return real(*args)

    device_build.select_candidates = spy
    try:
        (run or eng.rebuild_neighbors)()
    finally:
        device_build.select_candidates = real
    return calls


def bench_engine(dev, sort=False, jiggle=0.0, skin=BENCH["skin"], **config):
    """The bench scene on the card with its velocities; no lists yet.
    sort: spatially sorted atoms; jiggle: see shard_bench; config: REBOMoS
    force configuration."""
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.api.scenes import rebomos_bulk_commensurate
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.fixes.velocity import velocity_create
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    from lammps_plugins_tpu_torch.run.simulation import Engine
    state = rebomos_bulk_commensurate(BENCH["nx"], BENCH["ny"], BENCH["nz"],
                                      dtype=torch.float32, device=dev,
                                      sort=sort)
    if jiggle:
        rng = np.random.default_rng(7)
        state = state.replace(x=state.x + torch.as_tensor(
            rng.uniform(-jiggle, jiggle, tuple(state.x.shape)),
            dtype=torch.float32, device=dev))
    state = velocity_create(state, units.METAL, BENCH["temp"], BENCH["seed"])
    pair = REBOMoS.from_file(REBO_FILE, ["M", "S"], dtype=torch.float32,
                             device=dev, **config)
    return Engine(state, pair, [FixNVE()], units.METAL,
                  check_every=BENCH["check_every"], skin=skin)


#: flops of C's energy and virial rows per window pair, beside the 30 of
#: its force: v (5) and its sum (1), six fp d_a d_b (2 each)
LJ_ENERGY_VIRIAL_FLOPS = 18


def lj_virial_record(P, lc, ar, ok, npairs, slabs=None, plain=True):
    """Kernel C with with_virial (a thermo row's and stress/atom's launch)
    on planes P: its six rows within 2e-4 x their scale of the twin's per
    slot, the forces and energy row equal to `ok` (the with_energy
    launch's) bit for bit, reruns bit-identical; its median time, the
    twin's (unless plain is False) and the bound.  `slabs`: a_ranges along
    x to run the twin in (default: the whole range)."""
    from lammps_plugins_tpu_torch.ops import lj_cells
    ov, vk = lj_cells.lj_cell_forces(P, lc, ar, with_energy=True,
                                     with_virial=True)
    again = lj_cells.lj_cell_forces(P, lc, ar, with_energy=True,
                                    with_virial=True)
    torch.cuda.synchronize()
    if not (torch.equal(ov, ok) and torch.equal(again[0], ov)
            and torch.equal(again[1], vk)):
        raise AssertionError("lj_cell_forces with_virial changed the forces "
                             "or the energy row, or its reruns differ")
    del again
    x0 = ar[0][0]
    err = scale = 0.0
    for s in slabs or [ar]:
        _, vt = lj_cells.lj_cell_forces_ref(P, lc, s, with_virial=True)
        ks = vk[s[0][0] - x0:s[0][1] - x0]
        err = max(err, float((ks - vt).abs().max()))
        scale = max(scale, float(vt.abs().max()))
        del vt, ks
    b_ms, b_by = bound(4 * (P.numel() + ov.numel() + vk.numel()),
                       (30 + LJ_ENERGY_VIRIAL_FLOPS) * npairs)
    out = dict(max_abs_err=err, bar=2e-4 * scale,
               ms=timed_ms(lambda: lj_cells.lj_cell_forces(
                   P, lc, ar, with_energy=True, with_virial=True), reps=20),
               plain_ms=(timed_ms(lambda: lj_cells.lj_cell_forces_ref(
                   P, lc, ar, with_energy=True, with_virial=True), reps=3)
                   if plain else None),
               bound_ms=b_ms, bound_by=b_by, library_ms=None,
               forces_and_energy_bit_identical=True,
               reruns_bit_identical=True)
    print(f"lj_cell_forces with_virial: max_abs_err={err:.3e} (bar "
          f"{out['bar']:.3e}), kernel {out['ms']:.4f} ms, twin "
          f"{out['plain_ms']} ms, bound {b_ms:.4f} ms by {b_by}; forces and "
          f"energy row equal to the with_energy launch's bit for bit")
    if not err <= out["bar"]:
        raise AssertionError("lj_cell_forces virial rows disagree with the "
                             "twin's")
    return out


def phase1_kernels(dev, prev_tree=""):
    """Each kernel vs its twin on the bench scene's own tensors; with
    prev_tree, the LJ sweeps, select-k and the reaction combine of that
    tree's build timed in turns."""
    from lammps_plugins_tpu_torch.ops import (lj_cells, lj_half, mirror,
                                              mirror_rows, pin, react, rebo,
                                              select_candidates, select_k)
    eng = bench_engine(dev)
    cand_args = capture_candidate_calls(eng)[-1]
    pair, st, nbr = eng.pair, eng.state, eng.nbr
    prev_build = PREV.get("build") if prev_tree else None
    rl = nbr.lists["rebo"]
    K, Np = rl.idxT.shape
    Wp = -(-27 * eng._plan.cand_capacity // 128) * 128
    print(f"bench shapes: N={st.natoms} K={K} Np={Np} W={Wp} "
          f"C={nbr.cells.table.shape[1]} cell dims={nbr.cells.dims} "
          f"a_range={nbr.cells.a_range}")
    results = {}

    def record(name, err, bar, k_ms, t_ms, source, replaces, work,
               library_ms=None, **extra):
        """work: (bytes, flops[, sfu ops]) of the kernel's call."""
        b_ms, b_by = bound(*work)
        print(f"{name}: max_abs_err={err:.3e} (bar {bar:.3e}) "
              f"kernel {k_ms:.4f} ms, twin {t_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms by {b_by} ({work[0] / 1e6:.2f} MB, "
              f"{work[1] / 1e9:.4f} GFLOP), share {b_ms / k_ms:.3f}, "
              f"library {library_ms}"
              + "".join(f", {k} {v}" for k, v in extra.items()))
        if not err <= bar:
            raise AssertionError(f"{name} disagrees with its twin: "
                                 f"{err} > {bar}")
        results[name] = dict(name=name, route="cuda", source=source,
                             replaces=replaces, max_abs_err=err, bar=bar,
                             ms=k_ms, plain_ms=t_ms, bound_ms=b_ms,
                             bound_by=b_by, bound_share=b_ms / k_ms,
                             library_ms=library_ms, bytes=work[0],
                             flops=work[1], **extra)

    # A: REBO cotangents, bar 5e-4 * scale; its emit_rows form bit for bit
    planes = pair._rebo_planes(st.x, pair.el_of_type[st.type], nbr.ghosts,
                               rl, st.box.h)
    cst = pair._rebo_consts
    work = rebo_work(planes, cst)
    print(f"REBO live edges per atom at K={K} (n: atoms): "
          f"{ {n: c for n, c in enumerate(work[3]) if c} }")
    gk = rebo.rebo_cotangents(*planes, cst)
    gt = rebo.rebo_cotangents_ref(*planes, cst)
    scale = max(float(t.abs().max()) for t in gt)
    err = max(float((a - b).abs().max()) for a, b in zip(gk, gt))
    *g3, g4 = rebo.rebo_cotangents(*planes, cst, emit_rows=True)
    torch.cuda.synchronize()
    rows_exact = (all(torch.equal(g4[..., a], g3[a]) for a in range(3))
                  and not bool(g4[..., 3].any()))
    if not rows_exact:
        raise AssertionError("rebo_cotangents emit_rows differs from its "
                             "planes")
    again = rebo.rebo_cotangents(*planes, cst)
    if not all(torch.equal(a, b) for a, b in zip(gk, again)):
        raise AssertionError("rebo_cotangents reruns differ")
    del again
    record("rebo_cotangents", err, 5e-4 * scale,
           timed_ms(lambda: rebo.rebo_cotangents(*planes, cst), reps=20),
           timed_ms(lambda: rebo.rebo_cotangents_ref(*planes, cst), reps=3),
           "lammps_plugins_tpu_torch/csrc/rebo.cu",
           "lammps_plugins_tpu/ops/rebo_pallas.py:250", work[:3],
           K=K, live_edges_hist=work[3],
           emit_rows_bit_identical=rows_exact, reruns_bit_identical=True,
           emit_rows_ms=timed_ms(lambda: rebo.rebo_cotangents(
               *planes, cst, emit_rows=True), reps=20))

    # B: mirror combine, bar 1e-5 * scale (f32 sums in another order)
    mv = rl.mirvT.float()
    fk = mirror.mirror_combine(*gk, rl.mirT, mv)
    ft = mirror.mirror_combine_ref(*gk, rl.mirT, mv)
    err = float((fk - ft).abs().max())
    record("mirror_combine", err, 1e-5 * float(ft.abs().max()),
           timed_ms(lambda: mirror.mirror_combine(*gk, rl.mirT, mv)),
           timed_ms(lambda: mirror.mirror_combine_ref(*gk, rl.mirT, mv)),
           "lammps_plugins_tpu_torch/csrc/mirror.cu",
           "lammps_plugins_tpu/ops/mirror_pallas.py:93",
           (4 * 5 * K * Np + 4 * fk.numel(), 6 * K * Np))

    # F: mirror combine from the gathered emit_rows table, 1e-5 * scale
    gmir4 = g4.reshape(K * Np, 4)[rl.mirT.reshape(-1).long()] \
        .reshape(K, Np, 4)
    fk = mirror_rows.mirror_combine_rows(*g3, gmir4, mv)
    ft = mirror_rows.mirror_combine_rows_ref(*g3, gmir4, mv)
    record("mirror_combine_rows", float((fk - ft).abs().max()),
           1e-5 * float(ft.abs().max()),
           timed_ms(lambda: mirror_rows.mirror_combine_rows(*g3, gmir4, mv)),
           timed_ms(lambda: mirror_rows.mirror_combine_rows_ref(*g3, gmir4,
                                                                mv)),
           "lammps_plugins_tpu_torch/csrc/mirror_rows.cu",
           "lammps_plugins_tpu/ops/mirror_pallas.py:138",
           (4 * 8 * K * Np + 4 * fk.numel(), 6 * K * Np))

    # pin copy, exact, on the [R, 128], [K, 3 Np] and [Np, Wr] shapes
    stacked = torch.stack(g3, dim=-1)
    flat = stacked.reshape(-1)
    R = -(-flat.shape[0] // 128)
    Wr = 64 if 3 * K <= 64 else 128
    pin_inputs = {
        f"[{R},128]": torch.nn.functional.pad(
            flat, (0, R * 128 - flat.shape[0])).reshape(R, 128),
        f"[{K},{3 * Np}]": stacked.reshape(K, 3 * Np),
        f"[{Np},{Wr}]": torch.nn.functional.pad(
            torch.cat(g3).t(), (0, Wr - 3 * K)).contiguous()}
    # kernel and clone() in turns, medians of PIN_REPS each; the twin is
    # clone(), so it is also the one PyTorch call of the same function
    pin_err, pin_ms, pin_plain, pin_bound = 0.0, {}, {}, {}
    for shape, a in pin_inputs.items():
        out = pin.pin_copy(a)
        pin_err = max(pin_err, float((out - a).abs().max()))
        if not torch.equal(out, a):
            raise AssertionError(f"pin_copy {shape} is not exact")
        t = interleaved_ms({"kernel": lambda: pin.pin_copy(a),
                            "clone": lambda: a.clone()}, PIN_REPS)
        pin_ms[shape], pin_plain[shape] = t["kernel"], t["clone"]
        pin_bound[shape] = bound(8 * a.numel(), 0)[0]
        print(f"pin_copy {shape}: kernel {t['kernel']:.4f} ms, clone() "
              f"{t['clone']:.4f} ms, bound {pin_bound[shape]:.4f} ms "
              f"(medians of {PIN_REPS} in turns)")
    main = f"[{K},{3 * Np}]"
    record("pin_copy", pin_err, 0.0, pin_ms[main], pin_plain[main],
           "lammps_plugins_tpu_torch/csrc/pin.cu",
           "lammps_plugins_tpu/ops/pin_rows.py:85 (and :39, :51)",
           (8 * pin_inputs[main].numel(), 0), library_ms=pin_plain[main],
           ms_by_shape=pin_ms, plain_ms_by_shape=pin_plain,
           library_ms_by_shape=pin_plain, bound_ms_by_shape=pin_bound,
           reps=PIN_REPS)

    # C: LJ cell sweep, forces 2e-4 * scale, energy 2e-5 relative
    P = pair._cell_planes(st.x, nbr.ghosts, nbr.cells, st.box.h)
    ar, lc = nbr.cells.a_range, pair._lj_consts
    ok = lj_cells.lj_cell_forces(P, lc, ar, with_energy=True)
    ot = lj_cells.lj_cell_forces_ref(P, lc, ar, with_energy=True)
    errf = float((ok[..., :3, :] - ot[..., :3, :]).abs().max())
    again = lj_cells.lj_cell_forces(P, lc, ar, with_energy=True)
    if not torch.equal(ok, again):
        raise AssertionError("lj_cell_forces reruns differ")
    npairs = lj_window_pairs(P, lc, ar)
    C = P.shape[-1]
    ncand_prev = 27 * C ** 2 * int(np.prod([b - a for a, b in ar]))
    tested, live = lj_cells.candidate_pairs(P, lc, ar)
    per_group = lj_cells.TILE * lj_cells.GROUP
    print(f"LJ window pairs (owned A atom, ordered): {npairs}; slot pairs "
          f"tested: {tested * per_group} ({tested} of {live} (A tile, B "
          f"group) pairs with live slots survive culling); the first "
          f"design's 27-cell sweep: {ncand_prev}")
    prev = None
    if prev_build:
        prev = lj_launchers(prev_build, P, lc, ar)
        pc = prev["lj_cell_forces"]()
        torch.cuda.synchronize()
        print(f"previous design ({prev_tree}) C: max_abs_err "
              f"{float((pc[..., :3, :] - ot[..., :3, :]).abs().max()):.3e}")

    def turns(kernel, prev_fn):
        """(kernel ms, previous design's ms or None), in turns."""
        if prev_fn is None:
            return timed_ms(kernel), None
        t = interleaved_ms({"kernel": kernel, "prev": prev_fn}, 20)
        return t["kernel"], t["prev"]

    c_ms, c_prev = turns(lambda: lj_cells.lj_cell_forces(P, lc, ar),
                         prev and prev["lj_cell_forces"])
    ek, et = float(ok[..., 3, :].double().sum()), \
        float(ot[..., 3, :].double().sum())
    # the energy row atom by atom (read at aslot, as pe/atom reads it)
    row_k = ok[..., 3, :].reshape(-1)[nbr.cells.aslot]
    row_t = ot[..., 3, :].reshape(-1)[nbr.cells.aslot]
    erre, scale_e = float((row_k - row_t).abs().max()), \
        float(row_t.abs().max())
    print(f"lj energy: kernel {ek:.8e} twin {et:.8e} "
          f"rel {abs(ek - et) / abs(et):.3e} (bar 2e-5); per atom max "
          f"|err| {erre:.3e} (bar {1e-4 * scale_e:.3e}, 1e-4 x scale)")
    if not abs(ek - et) <= 2e-5 * abs(et):
        raise AssertionError("lj_cell_forces energy row disagrees")
    if not erre <= 1e-4 * scale_e:
        raise AssertionError("lj_cell_forces energy row disagrees atom by "
                             "atom")
    c_virial = lj_virial_record(P, lc, ar, ok, npairs)
    record("lj_cell_forces", errf,
           2e-4 * float(ot[..., :3, :].abs().max()), c_ms,
           timed_ms(lambda: lj_cells.lj_cell_forces_ref(P, lc, ar), reps=3),
           "lammps_plugins_tpu_torch/csrc/lj_cells.cu",
           "lammps_plugins_tpu/ops/lj_cells_pallas.py:204",
           (4 * (P.numel() + ok.numel()), 30 * npairs),
           energy_row_max_abs_err=erre, energy_row_bar=1e-4 * scale_e,
           window_pairs=npairs, candidate_pairs=tested * per_group,
           candidate_pairs_prev_design=ncand_prev, tested_groups=tested,
           live_groups=live, reruns_bit_identical=True,
           energy_ms=timed_ms(lambda: lj_cells.lj_cell_forces(
               P, lc, ar, with_energy=True)), with_virial=c_virial,
           **({"prev_design_ms": c_prev} if prev else {}))

    # E: Newton-half LJ, 2e-4 * scale vs its twin, and within 3e-4 * scale
    # of kernel C's atom forces after the aslot remap
    hk = lj_half.lj_cell_forces_half(P, lc, ar)
    ht = lj_half.lj_cell_forces_half_ref(P, lc, ar)
    f_half = hk.reshape(-1, 3)[nbr.cells.aslot]
    f_full = ok[..., 0:3, :].permute(0, 1, 2, 4, 3).reshape(-1, 3)[
        nbr.cells.aslot]
    sc = float(f_full.abs().max())
    err_c = float((f_half - f_full).abs().max())
    print(f"lj_cell_forces_half vs kernel C after the remap: "
          f"{err_c:.3e} (bar {3e-4 * sc:.3e})")
    if not err_c <= 3e-4 * sc:
        raise AssertionError("lj_cell_forces_half disagrees with kernel C")
    if not torch.equal(hk, lj_half.lj_cell_forces_half(P, lc, ar)):
        raise AssertionError("lj_cell_forces_half reruns differ")
    tested_h, live_h, blocks_h = lj_half.candidate_pairs_half(P, lc, ar)
    print(f"LJ half sweep: slot pairs tested {tested_h * per_group} "
          f"({tested_h} of {live_h} (A tile, B group) pairs with live slots "
          f"survive culling); the first design's: {blocks_h * C ** 2}")
    e_ms, e_prev = turns(lambda: lj_half.lj_cell_forces_half(P, lc, ar),
                         prev and prev["lj_cell_forces_half"])
    record("lj_cell_forces_half", float((hk - ht).abs().max()),
           2e-4 * float(ht.abs().max()), e_ms,
           timed_ms(lambda: lj_half.lj_cell_forces_half_ref(P, lc, ar),
                    reps=3),
           "lammps_plugins_tpu_torch/csrc/lj_half.cu",
           "lammps_plugins_tpu/ops/lj_cells_pallas.py:331",
           (4 * (P.numel() + hk.numel()), 33 * npairs / 2),
           max_abs_err_vs_kernel_c=err_c, window_pairs=npairs / 2,
           candidate_pairs=tested_h * per_group,
           candidate_pairs_prev_design=blocks_h * C ** 2,
           tested_groups=tested_h, live_groups=live_h,
           reruns_bit_identical=True,
           **({"prev_design_ms": e_prev} if prev else {}))

    # D: select_k on [N, W] candidate-like keys, exact
    N = st.natoms
    keys, ids, typ = select_k_keys(dev, N, Wp)
    sk = select_k.select_k(keys, K, payloads=(ids, typ))
    stw = select_k.select_k_ref(keys, K, payloads=(ids, typ))
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(sk, stw))
    if not all(torch.equal(a, b) for a, b in
               zip(sk, select_k.select_k(keys, K, payloads=(ids, typ)))):
        raise AssertionError("select_k reruns differ")
    hits = (keys < float("inf")).sum(dim=1)
    # yardstick, not a twin: topk's tie order differs from the stable rule
    fns = {"kernel": lambda: select_k.select_k(keys, K, (ids, typ)),
           "topk": lambda: torch.topk(keys, K, dim=1, largest=False,
                                      sorted=True)}
    if prev_build:
        fns["prev"] = select_k_launcher(prev_build, keys, K, (ids, typ))
        if not all(torch.equal(a, b) for a, b in zip(fns["prev"](), sk)):
            raise AssertionError(f"select_k of {prev_tree} disagrees")
    t = interleaved_ms(fns, 20)
    print(f"select_k rows with more than 32 finite keys: "
          f"{int((hits > 32).sum())} of {N} (mean "
          f"{float(hits.float().mean()):.2f})")
    record("select_k", err, 0.0, t["kernel"],
           timed_ms(lambda: select_k.select_k_ref(keys, K, (ids, typ))),
           "lammps_plugins_tpu_torch/csrc/select_k.cu",
           "lammps_plugins_tpu/ops/select_k_pallas.py:99",
           (4 * N * Wp + 8 * N * K + 12 * N * K, N * Wp),
           library_ms=t["topk"], W=Wp, reruns_bit_identical=True,
           rows_over_32_hits=int((hits > 32).sum()),
           **({"prev_design_ms": t["prev"]} if prev_build else {}))
    del eng, planes, gk, gt, g3, g4, gmir4, stacked, flat, pin_inputs, P
    del ok, ot, hk, ht, keys, ids, typ, again, prev, sk, stw, fns
    torch.cuda.empty_cache()

    # D': the rebuild's fused candidate selection on the bench rebuild's
    # own arguments; exact against its twin and against the unfused path
    # (the keys built in torch, then D), in turns with it and (prev_tree)
    # with the earlier tree's design; each design's time split by part
    from lammps_plugins_tpu_torch.ops import build as this_build
    ck = select_candidates.select_candidates(*cand_args)
    ct = select_candidates.select_candidates_ref(*cand_args)

    def unfused():
        return select_candidates.select_candidates_ref(
            *cand_args, select=select_k.select_k)

    fns = {"kernel": lambda: select_candidates.select_candidates(
        *cand_args), "unfused": unfused}
    if prev_build:
        fns["prev"] = candidates_launcher(prev_build, cand_args)[0]
    others = [ct] + [fn() for name, fn in fns.items() if name != "kernel"]
    again = select_candidates.select_candidates(*cand_args)
    diffs = [float((a.long() - b.long()).abs().max()) for other in others
             for a, b in zip(ck, other)]
    exact = all(torch.equal(a, b) for other in others + [again]
                for a, b in zip(ck, other))
    if not exact:
        raise AssertionError(f"select_candidates differs from its twin, the "
                             f"unfused path or {prev_tree}: {diffs}")
    xt_pad, dense_f, c3f, fdims, _, Kc = cand_args[:6]
    cwork = candidate_work(cand_args)
    t = interleaved_ms(fns, 20)
    split = candidates_split(this_build, cand_args, 20)
    prev_split = (candidates_split(prev_build, cand_args, 20) if prev_build
                  else {})
    print(f"select_candidates: n={c3f.shape[0]} K={Kc} Cf={dense_f.shape[1]} "
          f"fine cells {fdims}, kmax {int(ck[3])}, candidate pairs "
          f"{cwork[2]:.0f}; split {split}"
          + (f"; {prev_tree} {t['prev']:.4f} ms, split {prev_split}"
             if prev_build else ""))
    record("select_candidates", max(diffs), 0.0, t["kernel"],
           timed_ms(lambda: select_candidates.select_candidates_ref(
               *cand_args), reps=3),
           "lammps_plugins_tpu_torch/csrc/select_k.cu",
           "lammps_plugins_tpu/ops/select_k_pallas.py:99 with the keys of "
           "lammps_plugins_tpu/neighbor/device_build.py:718-784",
           cwork[:2], unfused_ms=t["unfused"], split_ms=split, K=Kc,
           W=27 * dense_f.shape[1], kmax=int(ck[3]),
           candidate_pairs=cwork[2], exact_vs_twin=True,
           exact_vs_unfused=True, reruns_bit_identical=True,
           **({"prev_design_ms": t["prev"], "prev_split_ms": prev_split,
               "exact_vs_prev_design": True} if prev_build else {}))
    del ck, ct, again, others, fns, cand_args, xt_pad, dense_f, c3f
    torch.cuda.empty_cache()

    # G: reaction combine on the route tables of the sorted scene's rebuild
    eng = bench_engine(dev, sort=True, combine="react", react_gate=False)
    eng.rebuild_neighbors()
    pair, st, nbr = eng.pair, eng.state, eng.nbr
    rl = nbr.lists["rebo"]
    planes = pair._rebo_planes(st.x, pair.el_of_type[st.type], nbr.ghosts,
                               rl, st.box.h)
    g3 = rebo.rebo_cotangents(*planes, pair._rebo_consts)
    rk = react.react_combine(*g3, rl.rtgt)
    rt = react.react_combine_target_ref(*g3, rl.rtgt)
    rr = react.react_combine_ref(*g3, rl.rblocks, rl.route)
    fm = mirror.mirror_combine(*g3, rl.mirT, rl.mirvT.float())
    sc = float(rt.abs().max())
    err_m = float((rk - fm).abs().max())
    err_r = float((rk - rr).abs().max())
    if not max(err_m, err_r) <= 1e-5 * sc:
        raise AssertionError(f"react_combine disagrees with the mirror "
                             f"combine ({err_m}) or the route tables' twin "
                             f"({err_r})")
    if not torch.equal(rk, react.react_combine(*g3, rl.rtgt)):
        raise AssertionError("react_combine reruns differ")
    fns = {"kernel": lambda: react.react_combine(*g3, rl.rtgt)}
    same_as_prev = None
    if prev_build:
        fns["prev"] = react_launcher(prev_build, g3, rl)
        same_as_prev = bool(torch.equal(fns["prev"](), rk))
        print(f"react_combine forces bit-identical to {prev_tree}'s: "
              f"{same_as_prev}")
        if not same_as_prev:
            raise AssertionError(f"react_combine differs from {prev_tree}'s")
    t = interleaved_ms(fns, 20)
    p = eng._plan
    Kr, Npr = g3[0].shape
    routed = int((rl.rtgt >= 0).sum())
    record("react_combine", float((rk - rt).abs().max()), 1e-5 * sc,
           t["kernel"],
           timed_ms(lambda: react.react_combine_target_ref(*g3, rl.rtgt)),
           "lammps_plugins_tpu_torch/csrc/react.cu",
           "lammps_plugins_tpu/ops/react_pallas.py:202 and :226",
           (4 * (3 * Kr * Npr + rl.rtgt.numel() + rk.numel()),
            3 * (Kr * Npr + routed + Npr)),
           max_abs_err_vs_mirror_combine=err_m,
           max_abs_err_vs_route_twin=err_r, reruns_bit_identical=True,
           routed_entries=routed, Dt=rl.rtgt.shape[0],
           NW_KC_QR=[p.react_nw, p.react_kc, p.react_qr],
           measured_NW_KC_QR=list(eng._react_hwm),
           **({"prev_design_ms": t["prev"],
               "bit_identical_to_prev_design": same_as_prev}
              if prev_build else {}))
    del eng, planes, g3, rk, rt, rr, fm, fns
    torch.cuda.empty_cache()
    return results


def phase2_f32_accuracy(dev):
    """288-atom scene: f32 kernel forces on the card vs f64 CPU twins."""
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.api.scenes import rebomos_bulk
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
    rms = float(np.sqrt(np.mean(f64 * f64)))
    err = float(np.abs(f32 - f64).max())
    print(f"288 atoms: max|F32 - F64| = {err:.3e} eV/A, RMS(F) = {rms:.3e}, "
          f"ratio {err / rms:.3e} (bar 1e-2)")
    if not err < 1e-2 * rms:
        raise AssertionError("f32 forces outside 1e-2 RMS(F)")


#: the kernels (by the names the profiler shows) that must run inside the
#: main path's graph replays: A, B, C and D'
GRAPH_KERNELS = ("rebo_cotangents_kernel", "mirror_combine_kernel",
                 "lj_cells_kernel", "select_candidates_kernel")
#: host calls that launch device work, and host calls that wait for it
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
                "cudaGraphLaunch")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
PROFILE_STEPS = 300
REBUILD_REPS = 10


def profile_run(eng, steps):
    """torch.profiler over eng.run(steps): device ops (kernels, copies,
    sets) executed per step and their device ms per step, host launch
    calls per step (kernels, copies, sets and graph launches), host syncs
    per 1,000 steps (the one closing the window left out), and the device
    ops by name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run(steps)
        torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    ops = [e for e in events if e.device_type == cuda]
    calls = collections.Counter(e.name for e in events
                                if e.device_type != cuda
                                and e.name.startswith("cu"))
    return dict(
        device_ops_per_step=len(ops) / steps,
        host_launch_calls_per_step=sum(calls[c] for c in LAUNCH_CALLS)
        / steps,
        graph_launches_per_step=calls["cudaGraphLaunch"] / steps,
        syncs_per_1000_steps=(sum(calls[c] for c in SYNC_CALLS) - 1)
        * 1000 / steps,
        device_ms_per_step=sum(e.time_range.elapsed_us() for e in ops)
        / steps / 1e3,
        host_calls=dict(sorted(calls.items())),
        device_ops=collections.Counter(e.name[:100] for e in ops))


def graph_rebuild_ms(eng, reps=REBUILD_REPS):
    """Wall ms that a rebuild adds to one iteration of the graph loop:
    reps replays with the rebuild's flag set before each, less reps with
    it cleared, host clock; the Engine's bookkeeping follows the replays."""
    loop = eng._device_loop()
    eng.state = loop.start(eng.state, eng.nbr, False, eng._seg_dprev)
    eng.nbr = loop.nbr

    def timed(pending):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            loop.pending.fill_(pending)
            loop.replay(1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps

    with_rb, without = timed(True), timed(False)
    res = loop.read()
    eng.state = eng.state.replace(step=loop.step0 + res.done)
    eng._pending_rebuild, eng._seg_dprev = res.pending, res.dprev
    eng.rebuilds += res.n_rb
    return 1e3 * (with_rb - without)


def eager_rebuild_ms(eng, reps=REBUILD_REPS):
    """Host-clock ms of rebuild_neighbors() (its flags copy included)."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.rebuild_neighbors()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def loop_numbers(engines, gpu, steps=TIMED_STEPS,
                 profile_steps=PROFILE_STEPS, kernels=GRAPH_KERNELS):
    """The graph and the eager loop in turns on their own Engines (same
    scene): three `steps`-step windows each, one profiled run of
    `profile_steps` each, then host-clock ms per rebuild.  `kernels` must
    show by name in the graph loop's profile."""
    natoms = next(iter(engines.values())).state.natoms
    out = {name: dict(windows=[], wall_ms_per_step=[], rebuilds=[])
           for name in engines}
    names = list(engines)
    for rep in range(TIMED_REPS):
        for name in (names if rep % 2 == 0 else names[::-1]):
            eng, o = engines[name], out[name]
            rb0 = eng.rebuilds
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run(steps)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            o["windows"].append(natoms * steps / dt)
            o["wall_ms_per_step"].append(1e3 * dt / steps)
            o["rebuilds"].append(eng.rebuilds - rb0)
    for name in names:
        out[name].update(profile_run(engines[name], profile_steps))
    for name in names:
        o = out[name]
        o["rebuild_host_ms"] = (graph_rebuild_ms(engines[name])
                                if name == "graph"
                                else eager_rebuild_ms(engines[name]))
    for name in names:
        o = out[name]
        print(f"{name} loop on {gpu}: atom-steps/s "
              f"{', '.join(f'{r:.6g}' for r in o['windows'])} (median "
              f"{statistics.median(o['windows']):.6g}; rebuilds "
              f"{o['rebuilds']}); wall ms/step "
              f"{', '.join(f'{w:.4f}' for w in o['wall_ms_per_step'])}; "
              f"device ms/step {o['device_ms_per_step']:.4f}; device "
              f"ops/step {o['device_ops_per_step']:.1f}; host launch calls/"
              f"step {o['host_launch_calls_per_step']:.2f} (graph launches "
              f"{o['graph_launches_per_step']:.3f}); host syncs per 1,000 "
              f"steps {o['syncs_per_1000_steps']:.1f}; host-clock ms per "
              f"rebuild {o['rebuild_host_ms']}")
        print(f"  {name} host calls in {profile_steps} steps: "
              f"{o['host_calls']}")
    graph_ops = out["graph"]["device_ops"]
    seen = {k: any(k in op for op in graph_ops) for k in kernels}
    print(f"graph loop profile: kernels by name {seen}")
    if not all(seen.values()):
        print("graph loop profile, device ops by count: "
              + json.dumps(graph_ops.most_common()))
        raise AssertionError(f"kernels missing from the graph loop's "
                             f"profile: {seen}")
    if out["graph"]["host_calls"].get("cudaGraphLaunch", 0) == 0:
        raise AssertionError("the graph loop's profile shows no graph "
                             "launch")
    for o in out.values():
        del o["device_ops"]
    return out


def phase3_main_path(dev, modules):
    """Engine.run on the bench scene through the graph loop (the default);
    every kernel must launch in it, and the state after RUN_STEPS must be
    bit-identical to an eager Engine's from the same start."""
    eng = bench_engine(dev)
    natoms = eng.state.natoms
    torch.cuda.reset_peak_memory_stats()
    for m in modules.values():
        m.launches = 0
    t0 = time.perf_counter()
    rows = eng.run(RUN_STEPS, thermo_every=RUN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: m.launches for name, m in modules.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    peak_reserved = torch.cuda.max_memory_reserved() / 2 ** 30
    print(f"main run (graph loop): {RUN_STEPS} steps in {wall:.2f} s (first "
          f"rebuild, plan sizing, capture and two thermo rows included), "
          f"launches {launches}, rebuilds {eng.rebuilds}; peak memory "
          f"{peak:.3f} GiB allocated, {peak_reserved:.3f} GiB reserved; "
          f"memory_usage {eng.memory_usage()}; capture (warm-up, two "
          f"captures, join, instantiate) {eng._loop.capture_s:.3f} s")
    if eng._loop is None or eng._loop.exec is None:
        raise AssertionError("the main path did not run through the graph")
    check_launches("main path", launches, MAIN_PATH)
    for r in rows:
        print(f"  step {r['step']} T {r['temp']:.6f} pe {r['pe']:.6f} "
              f"etotal {r['etotal']:.6f} press {r['press']:.4f}")
    check_run(eng, rows)

    ref = bench_engine(dev)
    ref.fused_loop = False
    ref.run(RUN_STEPS, thermo_every=RUN_STEPS)
    same = {a: bool(torch.equal(getattr(eng.state, a), getattr(ref.state, a)))
            for a in ("x", "v", "f", "image")}
    print(f"graph vs eager loop after {RUN_STEPS} steps: bit-identical "
          f"{same}, rebuilds {eng.rebuilds} / {ref.rebuilds}, steps "
          f"{eng.state.step} / {ref.state.step}")
    if not all(same.values()) or eng.rebuilds != ref.rebuilds:
        raise AssertionError("the graph loop's state differs from the "
                             "eager loop's")
    gpu = sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader")
    numbers = loop_numbers({"graph": eng, "eager": ref}, gpu)
    print("LOOPS " + json.dumps(dict(gpu=gpu, natoms=natoms,
                                     peak_gib=peak,
                                     peak_reserved_gib=peak_reserved,
                                     capture_s=eng._loop.capture_s,
                                     k_caps=dict(eng._plan.k_caps),
                                     **numbers)))
    del ref
    torch.cuda.empty_cache()
    return launches, rebo_at_run_k(eng)


def rebo_at_run_k(eng):
    """The REBO kernel against its twin on the run's own lists, at the K
    the run's re-sizes left (bar 5e-4 x scale); its time and bound."""
    from lammps_plugins_tpu_torch.ops import rebo
    pair, st, nbr = eng.pair, eng.state, eng.nbr
    planes = pair._rebo_planes(st.x, pair.el_of_type[st.type], nbr.ghosts,
                               nbr.lists["rebo"], st.box.h)
    cst = pair._rebo_consts
    K = planes[0].shape[0]
    gk = rebo.rebo_cotangents(*planes, cst)
    gt = rebo.rebo_cotangents_ref(*planes, cst)
    scale = max(float(t.abs().max()) for t in gt)
    err = max(float((a - b).abs().max()) for a, b in zip(gk, gt))
    work = rebo_work(planes, cst)
    b_ms, b_by = bound(*work[:3])
    out = dict(K=K, max_abs_err=err, bar=5e-4 * scale,
               ms=timed_ms(lambda: rebo.rebo_cotangents(*planes, cst),
                           reps=20),
               plain_ms=timed_ms(lambda: rebo.rebo_cotangents_ref(*planes,
                                                                  cst),
                                 reps=3),
               bound_ms=b_ms, bound_by=b_by, live_edges_hist=work[3])
    print(f"rebo_cotangents at the run's K={K}: max_abs_err={err:.3e} "
          f"(bar {out['bar']:.3e}) kernel {out['ms']:.4f} ms, twin "
          f"{out['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by {b_by}, "
          f"share {b_ms / out['ms']:.3f}; live edges per atom "
          f"{ {n: c for n, c in enumerate(work[3]) if c} }")
    if not err <= out["bar"]:
        raise AssertionError("rebo_cotangents disagrees with its twin at "
                             "the run's K")
    return out


def check_launches(label, launches, used):
    """Every kernel of the path launched; none that it replaces did."""
    missing = [m for m in used if launches[m] <= 0]
    stray = [m for m, c in launches.items() if c > 0 and m not in used]
    if missing or stray:
        raise AssertionError(f"{label}: kernels not launched {missing}, "
                             f"launched outside the path {stray}")


def check_run(eng, rows):
    """Finite thermo, positions and forces; NVE drift < 1e-6 eV/step/atom
    between the first and the last row."""
    for r in rows:
        if not all(np.isfinite(v) for v in r.values()):
            raise AssertionError(f"non-finite thermo row {r}")
    if not torch.isfinite(eng.state.x).all() \
            or not torch.isfinite(eng.state.f).all():
        raise AssertionError("non-finite positions or forces")
    steps = rows[-1]["step"] - rows[0]["step"]
    drift = abs(rows[-1]["etotal"] - rows[0]["etotal"]) \
        / (steps * eng.state.natoms)
    print(f"NVE drift {drift:.3e} eV/step/atom (bar 1e-6)")
    if not drift < 1e-6:
        raise AssertionError("NVE energy drift above 1e-6 eV/step/atom")
    return drift


def phase4_configurations(dev, modules):
    """The other force configurations, each its own Engine at the bench
    width; returns {config name: launches of its run}."""
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    out = {}
    for name, config, sort, used in CONFIGS:
        eng = bench_engine(dev, sort=sort, **config)
        natoms = eng.state.natoms
        eng.rebuild_neighbors()
        st, nbr = eng.state, eng.nbr
        default = REBOMoS.from_file(REBO_FILE, ["M", "S"],
                                    dtype=torch.float32, device=dev)
        with torch.no_grad():
            f_cfg = eng.pair.forces(st.x, st.type, nbr, st.box.h)
            f_def = default.forces(st.x, st.type, nbr, st.box.h)
        sc = float(f_def.abs().max())
        err = float((f_cfg - f_def).abs().max())
        print(f"config {name} {config} sort={sort}: step-0 forces vs the "
              f"default configuration {err:.3e} (bar {3e-4 * sc:.3e})")
        if not err <= 3e-4 * sc:
            raise AssertionError(f"config {name}: step-0 forces off")
        del f_cfg, f_def
        for m in modules.values():
            m.launches = 0
        t0 = time.perf_counter()
        rows = eng.run(RUN_STEPS, thermo_every=RUN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {m: mod.launches for m, mod in modules.items()}
        print(f"  {RUN_STEPS} steps through the graph loop in {wall:.2f} s, "
              f"launches {launches}")
        if eng._loop is None or eng._loop.exec is None:
            raise AssertionError(f"config {name} did not run through the "
                                 "graph")
        if "lj_cells" not in used:
            # each thermo row launches C for its energy and virial rows
            if launches["lj_cells"] != len(rows):
                raise AssertionError(f"config {name}: C launched "
                                     f"{launches['lj_cells']} times for "
                                     f"{len(rows)} thermo rows")
            launches = dict(launches, lj_cells=0)
        check_launches(f"config {name}", launches, used)
        check_run(eng, rows)
        p = eng._plan
        route = ""
        if config.get("combine") == "react":
            if not p.react_nw > 0:
                raise AssertionError("config react: plan.react_nw is 0")
            route = (f"; NW/KC/QR {p.react_nw}/{p.react_kc}/{p.react_qr} "
                     f"(measured high-water {eng._react_hwm})")
        rb0 = eng.rebuilds
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(TIMED_STEPS)
        torch.cuda.synchronize()
        rate = natoms * TIMED_STEPS / (time.perf_counter() - t0)
        print(f"  timed run: {TIMED_STEPS} steps, {rate:.6g} atom-steps/s "
              f"({natoms} atoms, f32), {eng.rebuilds - rb0} rebuilds, "
              f"K={dict(p.k_caps)}{route}")
        out[name] = launches
        del eng, default
        torch.cuda.empty_cache()
    return out


def phase5_golden(dev, path):
    """in.rebomos-bulk thermo rows against the reference log."""
    if not path:
        print("golden log: skipped (needs the published MoS.REBO.set5b, "
              "which is not in the repository; pass --golden-rebo PATH)")
        return
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.api.scenes import rebomos_bulk
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    from lammps_plugins_tpu_torch.run.simulation import Engine
    pair = REBOMoS.from_file(path, ["M", "S"], dtype=torch.float32,
                             device=dev)
    eng = Engine(rebomos_bulk(dtype=torch.float32, device=dev), pair,
                 [FixNVE()], units.METAL)
    rows = eng.run(20, thermo_every=10)
    for row, (step, g_t, g_pe) in zip(rows, GOLDEN):
        print(f"golden step {step}: T {row['temp']:.6f} ({g_t}) "
              f"pe {row['pe']:.4f} ({g_pe})")
        # f32 on the card: bars of the f32 class, not the f64 gate's
        if abs(row["pe"] - g_pe) > 1e-5 * abs(g_pe) \
                or abs(row["temp"] - g_t) > 1e-3 * max(1.0, g_t):
            raise AssertionError(f"golden row {step} off: {row}")


def aeam_engine(dev, fused=None, poly_mode=False):
    """The sample.in scene on the card (f32) with its NVT velocities and
    fix; no lists yet.  fused None: the Engine's default loop (the graph
    loop on the card); False: the eager loop."""
    from lammps_plugins_tpu_torch.api.scenes import alsi_sample
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nvt import FixNVT
    from lammps_plugins_tpu_torch.fixes.velocity import velocity_create
    from lammps_plugins_tpu_torch.potentials.aeam import AEAM as Style
    from lammps_plugins_tpu_torch.run.simulation import Engine
    state = alsi_sample(nc=AEAM["nc"], dtype=torch.float32, device=dev)
    state = velocity_create(state, units.METAL, AEAM["temp"], AEAM["seed"])
    pair = Style.from_file(AEAM_FILE, ["Al", "Si"], dtype=torch.float32,
                           device=dev, poly_mode=poly_mode)
    eng = Engine(state, pair, [FixNVT(AEAM["temp"], AEAM["temp"],
                                      AEAM["t_damp"])], units.METAL,
                 check_every=AEAM["check_every"], skin=AEAM["skin"])
    eng.fused_loop = fused
    return eng


def candidates_record(eng, label, ks=(), args=None):
    """D' on the arguments of a rebuild of `eng` (eng.rebuild_neighbors()),
    or on `args`, at the plan's K and at each K of `ks`, exact against its
    twin; at the plan's K its median time, the twin's, the bound and the
    rows' hits."""
    from lammps_plugins_tpu_torch.ops import select_candidates
    if args is None:
        args = capture_candidate_calls(eng)[-1]
    K = args[5]
    diffs, hits = [], None
    for k in (K, *ks):
        a = args[:5] + (k,) + args[6:]
        ck = select_candidates.select_candidates(*a)
        ct = select_candidates.select_candidates_ref(*a)
        again = select_candidates.select_candidates(*a)
        diffs.append(max(float((x.long() - y.long()).abs().max())
                         for x, y in zip(ck, ct)))
        if not all(torch.equal(x, y) and torch.equal(x, z)
                   for x, y, z in zip(ck, ct, again)):
            raise AssertionError(f"select_candidates of the {label} rebuild, "
                                 f"K={k}, differs from its twin: {diffs[-1]}")
        if hits is None:
            hits, kmax, first = ck[2].sum(dim=1), int(ck[3]), ck
        print(f"{label} select_candidates K={k}: exact against its twin, "
              f"kmax {int(ck[3])}")
    n, Cf = args[2].shape[0], args[1].shape[1]
    work = candidate_work(args)
    b_ms, b_by = bound(*work[:2])
    fns = {"kernel": lambda: select_candidates.select_candidates(*args)}
    prev = PREV.get("build")
    if prev:
        fns["prev"] = candidates_launcher(prev, args)[0]
        if not all(torch.equal(x, y) for x, y in zip(fns["prev"](), first)):
            raise AssertionError(f"select_candidates of the {label} rebuild "
                                 f"differs from {PREV['tree']}'s")
    t = interleaved_ms(fns, 20)
    ms = t["kernel"]
    plain = timed_ms(lambda: select_candidates.select_candidates_ref(*args),
                     3)
    out = dict(K=K, W=27 * Cf, Cf=Cf, n=n, kmax=kmax,
               rows_without_hits=int((hits == 0).sum()),
               mean_hits=float(hits.float().mean()), max_abs_err=max(diffs),
               ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
               bytes=work[0], flops=work[1], candidate_pairs=work[2],
               exact_at_k=[K, *ks], library_ms=None,
               split_ms=candidates_split(PREV["this"], args, 10))
    if prev:
        out.update(prev_design_ms=t["prev"],
                   prev_split_ms=candidates_split(prev, args, 10))
    print(f"{label} select_candidates: n={n} K={K} Cf={Cf} fine cells "
          f"{args[3]}, hits a row mean {out['mean_hits']:.2f}, rows without "
          f"hits {out['rows_without_hits']}, candidate pairs {work[2]:.0f}; "
          f"kernel {ms:.4f} ms, twin {plain:.4f} ms, bound {b_ms:.4f} ms by "
          f"{b_by} ({work[0] / 1e6:.2f} MB), share {b_ms / ms:.3f}; split "
          f"{out['split_ms']}"
          + (f"; {PREV['tree']} {out['prev_design_ms']:.4f} ms, split "
             f"{out['prev_split_ms']}" if prev else ""))
    return out


def aeam_candidates(eng):
    """D' on the AEAM rebuild at the plan's K and at K = 224 and 256
    (candidates_record); select-k (D) on synthetic rows of up to 300 hits
    at K = 224 and 256, exact.  Returns D''s record."""
    from lammps_plugins_tpu_torch.ops import select_k
    out = candidates_record(eng, "AEAM", ks=(224, 256))
    dev = eng.state.x.device
    for k, W, hits in ((224, 512, 200), (256, 1024, 256), (256, 1024, 300)):
        g = torch.Generator(device=dev).manual_seed(k + hits)
        keys = torch.full((4096, W), float("inf"), device=dev)
        cols = torch.argsort(torch.rand((4096, W), generator=g, device=dev),
                             dim=1)[:, :hits]
        vals = torch.round(torch.rand((4096, hits), generator=g,
                                      device=dev) * 256.0) / 16.0
        keys.scatter_(1, cols, vals)
        ids = torch.randint(0, 2 ** 24, (4096, W), generator=g,
                            device=dev).float()
        typ = torch.randint(1, 3, (4096, W), generator=g, device=dev).float()
        sk = select_k.select_k(keys, k, payloads=(ids, typ))
        st = select_k.select_k_ref(keys, k, payloads=(ids, typ))
        if not all(torch.equal(a, b) for a, b in zip(sk, st)):
            raise AssertionError(f"select_k differs from its twin at K={k}, "
                                 f"{hits} hits a row")
        print(f"select_k K={k} W={W}, {hits} hits a row: exact")
    return out


def aeam_f32_accuracy(dev):
    """max|F32 - F64| / RMS(F) of the jiggled nc=6 scene with 5 % Si: the
    f32 path on the card (its own device rebuild) against the f64 CPU
    twin (its own), exact spline path and poly_mode; bar 1e-2."""
    from lammps_plugins_tpu_torch.api.scenes import alsi_sample
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.core.box import Box
    from lammps_plugins_tpu_torch.core.state import State
    from lammps_plugins_tpu_torch.fixes.nvt import FixNVT
    from lammps_plugins_tpu_torch.potentials.aeam import AEAM as Style
    from lammps_plugins_tpu_torch.run.simulation import Engine
    base = alsi_sample(nc=6, si_fraction=0.05, dtype=torch.float64,
                       device="cpu")
    rng = np.random.default_rng(AEAM["seed"])
    pos = base.x.numpy() + rng.uniform(-0.1, 0.1, base.x.shape)
    types = base.type.numpy()
    out = {}
    for poly in (False, True):
        forces = []
        for dtype, device in ((torch.float64, "cpu"), (torch.float32, dev)):
            box = Box.orthogonal(base.box.h_np().diagonal(), dtype=dtype,
                                 device=device)
            pair = Style.from_file(AEAM_FILE, ["Al", "Si"], dtype=dtype,
                                   device=device, poly_mode=poly)
            st = State.create(x=pos, type=types, box=box, mass=pair.masses)
            eng = Engine(st, pair, [FixNVT(863.0, 863.0, 0.1)],
                         units.METAL, skin=AEAM["skin"])
            eng.rebuild_neighbors()
            with torch.no_grad():
                f = pair.forces(eng.state.x, eng.state.type, eng.nbr,
                                eng.state.box.h)
            forces.append(f.double().cpu().numpy())
        f64, f32 = forces
        rms = float(np.sqrt(np.mean(f64 * f64)))
        err = float(np.abs(f32 - f64).max())
        name = "poly_mode" if poly else "exact"
        print(f"AEAM nc=6 ({len(types)} atoms, {int((types == 2).sum())} Si) "
              f"{name}: max|F32 - F64| = {err:.3e} eV/A, RMS(F) = "
              f"{rms:.3e}, ratio {err / rms:.3e} (bar 1e-2)")
        if not err < 1e-2 * rms:
            raise AssertionError(f"AEAM {name} f32 forces outside 1e-2 "
                                 "RMS(F)")
        out[name] = err / rms
    return out


def nvt_run(eng, steps, every):
    """eng.run(steps), thermo rows every `every` steps with the NVT
    conserved quantity pe + ke + FixNVT.energy beside each."""
    fix = eng.fixes[0]
    rows = []

    def note(row):
        row["conserved"] = row["pe"] + row["ke"] + float(
            fix.energy(eng.state, eng.ctx))
        rows.append(row)

    eng.run(steps, thermo_every=every, on_thermo=note)
    return rows


def aeam_run(eng):
    """The main path's two runs (AEAM_RUN_STEPS), nvt_run's rows."""
    first, last = AEAM_RUN_STEPS
    return (nvt_run(eng, first, first // 2)
            + nvt_run(eng, last, AEAM["check_every"]))


def phase6_aeam(dev, modules):
    """pair_style aeam + fix nvt on the sample.in scene: D' past K = 128,
    f32 forces, the main path through the graph loop against the eager
    loop, and both loops' numbers.  Returns D''s AEAM record."""
    cand = aeam_candidates(aeam_engine(dev))
    torch.cuda.empty_cache()
    accuracy = aeam_f32_accuracy(dev)
    eng = aeam_engine(dev)
    natoms = eng.state.natoms
    nsi = int((eng.state.type == 2).sum())
    torch.cuda.reset_peak_memory_stats()
    for m in modules.values():
        m.launches = 0
    t0 = time.perf_counter()
    rows = aeam_run(eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: m.launches for name, m in modules.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = sum(AEAM_RUN_STEPS)
    print(f"AEAM main run (graph loop): {natoms} atoms ({nsi} Si), {steps} "
          f"steps in {wall:.2f} s (plan sizing, capture and thermo rows "
          f"included), launches {launches}, rebuilds {eng.rebuilds}, K "
          f"{dict(eng._plan.k_caps)}, peak memory {peak:.3f} GiB, "
          f"memory_usage {eng.memory_usage()}")
    if eng._loop is None or eng._loop.exec is None:
        raise AssertionError("the AEAM main path did not run through the "
                             "graph")
    check_launches("AEAM main path", launches, ("select_candidates",))
    for r in rows:
        if not all(np.isfinite(v) for v in r.values()):
            raise AssertionError(f"non-finite AEAM thermo row {r}")
    if not torch.isfinite(eng.state.x).all() \
            or not torch.isfinite(eng.state.f).all():
        raise AssertionError("non-finite AEAM positions or forces")
    for r in rows[::2] + rows[-1:]:
        print(f"  step {r['step']} T {r['temp']:.4f} pe {r['pe']:.6f} "
              f"conserved {r['conserved']:.6f} press {r['press']:.3f}")
    drift = (abs(rows[-1]["conserved"] - rows[0]["conserved"])
             / (rows[-1]["step"] - rows[0]["step"]) / natoms)
    tail = [r["temp"] for r in rows if r["step"] > steps - AEAM_RUN_STEPS[1]]
    mean_t = float(np.mean(tail))
    print(f"AEAM NVT conserved-quantity drift {drift:.3e} eV/step/atom; mean "
          f"T of the last {AEAM_RUN_STEPS[1]} steps ({len(tail)} rows) "
          f"{mean_t:.2f} K")

    ref = aeam_engine(dev, fused=False)
    aeam_run(ref)
    same = {a: bool(torch.equal(getattr(eng.state, a),
                                getattr(ref.state, a)))
            for a in ("x", "v", "f", "image")}
    chain, rchain = eng.state.extras["nvt:nvt"], ref.state.extras["nvt:nvt"]
    same.update({f"nvt {k}": bool(torch.equal(chain[k], rchain[k]))
                 for k in ("eta", "eta_dot", "step")})
    print(f"AEAM graph vs eager loop after {steps} steps: bit-identical "
          f"{same}, rebuilds {eng.rebuilds} / {ref.rebuilds}")
    if not all(same.values()) or eng.rebuilds != ref.rebuilds:
        raise AssertionError("the AEAM graph loop's state differs from the "
                             "eager loop's")
    gpu = sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader")
    numbers = loop_numbers({"graph": eng, "eager": ref}, gpu,
                           steps=AEAM_TIMED_STEPS,
                           profile_steps=AEAM_PROFILE_STEPS,
                           kernels=("select_candidates_kernel",))
    print("AEAM " + json.dumps(dict(
        gpu=gpu, natoms=natoms, si=nsi, k_caps=dict(eng._plan.k_caps),
        cand_capacity=eng._plan.cand_capacity, rebuilds=eng.rebuilds,
        nvt_drift_ev_per_step_atom=drift, mean_t_last_96=mean_t,
        peak_gib=peak, capture_s=eng._loop.capture_s,
        f32_force_err_over_rms=accuracy, select_candidates=cand,
        **numbers)))
    cand["launches"] = launches["select_candidates"]
    del eng, ref
    torch.cuda.empty_cache()
    return cand


def free_card(label):
    """Collect what the finished phases left and empty the allocator's
    cache; print what stays allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    print(f"before {label}: {torch.cuda.memory_allocated() / 2 ** 30:.3f} "
          f"GiB allocated, {torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB "
          f"reserved")


def same_state(a, b):
    """{field: bit-identical} of two Engines' x, v, f, image and every
    state.extras tensor, and their rebuild counts."""
    from lammps_plugins_tpu_torch.run.device_loop import extras_items
    same = {f: bool(torch.equal(getattr(a.state, f), getattr(b.state, f)))
            for f in ("x", "v", "f", "image")}
    ea, eb = (dict(extras_items(e.state.extras)) for e in (a, b))
    if list(ea) != list(eb):
        raise AssertionError(f"extras differ in keys: {list(ea)} {list(eb)}")
    same.update({":".join(p): bool(torch.equal(t, eb[p]))
                 for p, t in ea.items()})
    same["rebuilds"] = a.rebuilds == b.rebuilds
    return same


#: the cyclotron oracle of tests/test_fixes.py:17-66 on the card in f32:
#: n^3 free ions (m = 1, q = 1) `spacing` apart, each at v0 in a seeded
#: direction of the xy plane, B along z.  With qBm2f = e / amu / 1e12 =
#: 9.649e-5 (metal units, fix_bfield.cpp:186-188), 1000 T gives omega =
#: 0.0965 rad/ps, a radius of 5.18 A and a period of 65.1 ps; dt = period /
#: 2000 is a step of 0.0163 A (~2,100 f32 ulps at 80 A), omega dt 3.1e-3
CYCLO = dict(n=16, spacing=10.0, bz=1000.0, v0=0.5, seed=2024)
#: config 2 (BASELINE.json configs[1]): tests/test_ljcut.py's CHARGED_MELT
#: deck at n = 32 (65,536 ions, 134.4 A box) with the deck's 200 T (omega
#: dt = 8.4e-7 for Na+, inside the weak-field bound 2 pi 0.001); and
#: LAMMPS's bench/in.lj, the LJ_MELT deck at n = 20 (32,000 atoms)
DECKS = dict(melt=32, lj=20)
DECK_RUN_STEPS = 300
DECK_PROFILE_STEPS = 100
MELT_BZ = 200.0


def cyclotron_oracle(dev, modules):
    """Free ions in a uniform Bz for one period through the graph loop
    (pair_style none, cutoff 1 A: most rows of the lists have no hit);
    every ion must be back: |x - x0| < 5e-3 v0 period, each velocity
    component within 5e-3 v0 of its start, the speed within 1e-3 v0."""
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.core.box import Box
    from lammps_plugins_tpu_torch.core.state import State
    from lammps_plugins_tpu_torch.fixes.bfield import FixBfield
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.potentials.none import PairNone
    from lammps_plugins_tpu_torch.run.simulation import Engine
    u = units.METAL
    n, a, bz, v0 = (CYCLO[k] for k in ("n", "spacing", "bz", "v0"))
    g = (np.arange(n) + 0.5) * a
    x0 = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    phi = np.random.default_rng(CYCLO["seed"]).uniform(0.0, 2 * np.pi,
                                                        len(x0))
    vel0 = v0 * np.stack([np.cos(phi), np.sin(phi), np.zeros_like(phi)], 1)
    box = Box.orthogonal([n * a] * 3, dtype=torch.float32, device=dev)
    st = State.create(x=x0, type=np.ones(len(x0), np.int64), box=box,
                      mass=np.array([0.0, 1.0]), v=vel0, q=np.ones(len(x0)))
    period = 2 * np.pi / (u.qBm2f * bz)
    eng = Engine(st, PairNone(1.0), [FixBfield(0.0, 0.0, bz), FixNVE()], u,
                 dt=period / 2000)
    for m in modules.values():
        m.launches = 0
    t0 = time.perf_counter()
    eng.run(2000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: m.launches for name, m in modules.items()}
    if eng._loop is None or eng._loop.exec is None:
        raise AssertionError("the cyclotron run did not use the graph loop")
    check_launches("cyclotron", launches, ("select_candidates",))
    s = eng.state
    x = s.box.unmap(s.x, s.image).double().cpu().numpy()
    v = s.v.double().cpu().numpy()
    out = dict(ions=len(x0), bz=bz, v0=v0, period_ps=period,
               dt_ps=period / 2000, steps=2000, wall_s=wall,
               rebuilds=eng.rebuilds, K=dict(eng._plan.k_caps),
               rows_without_hits_last_list=int(
                   (~eng.nbr.lists["main"].mask.any(dim=1)).sum()),
               max_dx=float(np.linalg.norm(x - x0, axis=1).max()),
               max_dv=float(np.abs(v - vel0).max()),
               max_dspeed=float(np.abs(np.linalg.norm(v, axis=1) - v0).max()),
               bars=[5e-3 * v0 * period, 5e-3 * v0, 1e-3 * v0],
               launches=launches["select_candidates"])
    print(f"cyclotron oracle ({len(x0)} ions, B {bz} T, f32, graph loop): "
          f"one period in {wall:.2f} s, {eng.rebuilds} rebuilds, max|dx| "
          f"{out['max_dx']:.3e} A (bar {out['bars'][0]:.3e}), max|dv| "
          f"{out['max_dv']:.3e} (bar {out['bars'][1]:.3e}), max||v| - v0| "
          f"{out['max_dspeed']:.3e} (bar {out['bars'][2]:.3e}), rows "
          f"without hits {out['rows_without_hits_last_list']}")
    if not (out["max_dx"] < out["bars"][0] and out["max_dv"] < out["bars"][1]
            and out["max_dspeed"] < out["bars"][2]):
        raise AssertionError("the cyclotron oracle failed on the card")
    # D' on this run's rows without hits, exact against its twin
    out["select_candidates"] = candidates_record(eng, "cyclotron")
    return out


def deck_engine(dev, name, fused=None, dtype=torch.float32, device=None,
                state=None):
    """The Engine of the deck `name` ("melt": charged_melt, "lj": lj_melt)
    at its DECKS size; fused as in aeam_engine; state: another state of the
    deck's atoms in place of the scene's."""
    from lammps_plugins_tpu_torch.api.scenes import charged_melt, lj_melt
    device = dev if device is None else device
    deck = (charged_melt(DECKS["melt"], bz=MELT_BZ, dtype=dtype,
                         device=device) if name == "melt"
            else lj_melt(DECKS["lj"], dtype=dtype, device=device))
    if state is not None:
        deck.state = state
    eng = deck.engine()
    eng.fused_loop = fused
    return eng


def ljcut_f32_accuracy(dev, cases=None):
    """max|F_f32 - F_f64| / RMS(F) of each (name, deck maker, n, jiggle) of
    `cases`, by default the jiggled charged_melt(6) (432 ions) and
    lj_melt(6) (864 atoms): the f32 path on the card against the f64 path
    on the CPU, each on its own device rebuild's lists, the same
    positions, types and charges (the f64 scene's); bar 1e-2."""
    from lammps_plugins_tpu_torch.api.scenes import charged_melt, lj_melt
    out = {}
    for name, make, n, jiggle in cases or (
            ("charged_melt", charged_melt, 6, 0.1),
            ("lj_melt", lj_melt, 6, 0.05)):
        base = make(n, dtype=torch.float64, device="cpu").state
        rng = np.random.default_rng(AEAM["seed"])
        pos = base.x.numpy() + rng.uniform(-jiggle, jiggle, base.x.shape)
        forces = []
        for dtype, device in ((torch.float64, "cpu"), (torch.float32, dev)):
            deck = make(n, dtype=dtype, device=device)
            deck.state = deck.state.replace(
                x=torch.as_tensor(pos, dtype=dtype, device=device),
                type=base.type.to(device),
                q=base.q.to(device=device, dtype=dtype))
            eng = deck.engine()
            eng.rebuild_neighbors()
            st = eng.state
            with torch.no_grad():
                f = eng.pair.forces(st.x, st.type, eng.nbr, st.box.h)
            forces.append(f.double().cpu().numpy())
        f64, f32 = forces
        rms = float(np.sqrt(np.mean(f64 * f64)))
        err = float(np.abs(f32 - f64).max())
        print(f"{name}({n}) ({len(pos)} atoms): max|F32 - F64| = "
              f"{err:.3e}, RMS(F) = {rms:.3e}, ratio {err / rms:.3e} (bar "
              "1e-2)")
        if not err < 1e-2 * rms:
            raise AssertionError(f"{name} f32 forces outside 1e-2 RMS(F)")
        out[name] = err / rms
    return out


#: kernel I's shapes: lj_melt(n), in.lj at 32,000 atoms and the lj-nve
#: cell's 864,000, every atom displaced in [-0.05, 0.05] sigma
LJCUT_SIZES = (20, 60)


def ljcut_live_slots(pair, st, nbr) -> int:
    """The list slots kernel I computes a force for: masked in and inside
    the type pair's cut."""
    from lammps_plugins_tpu_torch.neighbor.neighbor import edge_components
    nlist = nbr.lists["main"]
    _, _, _, rsq, mask = edge_components(st.x, nbr.ghosts, nlist, st.box.h)
    cutsq = pair._tables()[2]
    flat = pair._edge_flat_types(st.type, nbr, nlist)
    return int((mask & (rsq < cutsq[flat])).sum())


def ljcut_kernel_record(dev, n):
    """Kernel I on lj_melt(n)'s own device rebuild: one launch, against its
    twin (1e-5 x rms|F|) and against the [N, K] edge sweep plus mirror
    combine (1e-5 x rms|F| on rows without a ghost neighbour, 1e-4 on the
    others: the f32 rounding of ghost images, as in
    tests/test_torch_cuda.py), a rerun and a call on the list padded by 40
    masked slots bit for bit; the median device ms of the kernel, its twin
    and the mirror path in turns, and the bound: the list read once (idx int64
    and mask, 9 bytes a slot), the owned rows, the ghost table, the float4
    table written and read once and the forces written, or 25 flops a live
    slot."""
    from lammps_plugins_tpu_torch.api.scenes import lj_melt
    from lammps_plugins_tpu_torch.ops import ljcut
    deck = lj_melt(n, device=dev)
    st = deck.state
    rng = np.random.default_rng(AEAM["seed"])
    deck.state = st.replace(x=st.x + torch.as_tensor(
        rng.uniform(-0.05, 0.05, st.x.shape), dtype=st.x.dtype, device=dev))
    eng = deck.engine()
    eng.rebuild_neighbors()
    st, nbr, pair = eng.state, eng.nbr, eng.pair
    nlist = nbr.lists["main"]
    N, K = nlist.idx.shape
    Mg = nbr.ghosts.count
    args, kw = pair.kernel_inputs(st.x, st.type, nbr, st.box.h)
    before = ljcut.launches
    f = pair.forces(st.x, st.type, nbr, st.box.h)
    torch.cuda.synchronize()
    if ljcut.launches != before + 1:
        raise AssertionError("kernel I: not one launch a force call")
    f_twin = ljcut.ljcut_forces_ref(*args, **kw)
    f_mirror = pair.mirror_forces(st.x, st.type, nbr, st.box.h)
    rms = float(f_mirror.double().pow(2).sum(1).mean().sqrt())
    ghost = ((nlist.idx >= N) & nlist.mask).any(dim=1)
    gap_t = float((f - f_twin).double().abs().max()) / rms
    gap_m = (f - f_mirror).double().abs().max(dim=1).values / rms
    gap_in, gap_all = float(gap_m[~ghost].max()), float(gap_m.max())
    rerun = torch.equal(f, pair.forces(st.x, st.type, nbr, st.box.h))
    # the same rows in a list of 40 more slots: the same bits
    wide = list(args)
    wide[5] = torch.nn.functional.pad(args[5], (0, 40))
    wide[6] = torch.nn.functional.pad(args[6], (0, 40))
    rerun = rerun and torch.equal(f, ljcut.ljcut_forces(*wide, **kw))
    del wide
    live = ljcut_live_slots(pair, st, nbr)
    del f_twin, f_mirror
    times = interleaved_ms({
        "kernel": lambda: pair.forces(st.x, st.type, nbr, st.box.h),
        "twin": lambda: ljcut.ljcut_forces_ref(*args, **kw),
        "mirror": lambda: pair.mirror_forces(st.x, st.type, nbr, st.box.h)},
        reps=10)
    nbytes = N * K * 9 + N * (12 + 8 + 16 + 12) + Mg * (8 + 12) \
        + (N + Mg) * 16
    bms, by = bound(nbytes, 25 * live)
    rec = dict(natoms=N, K=K, ghosts=Mg, live_slots=live, rms_f=rms,
               err_twin=gap_t, err_mirror_no_ghost=gap_in, err_mirror=gap_all,
               rerun_equal=rerun, kernel_ms=times["kernel"],
               twin_ms=times["twin"], mirror_path_ms=times["mirror"],
               bound_ms=bms, bound_by=by, share=bms / times["kernel"],
               library_ms="no single PyTorch call")
    print(f"kernel I on lj_melt({n}) ({N} atoms, K {K}, {Mg} ghosts, "
          f"{live} live slots): max|dF| / rms|F| against the twin "
          f"{gap_t:.3e} (bar 1e-5), against the mirror combine {gap_in:.3e} "
          f"on rows without a ghost neighbour (bar 1e-5), {gap_all:.3e} on "
          f"all (bar 1e-4); rerun and K + 40 bit-identical {rerun}; device "
          f"ms kernel {times['kernel']:.4f}, twin {times['twin']:.4f}, "
          f"edge sweep + mirror combine {times['mirror']:.4f}; bound "
          f"{bms:.4f} ms ({by}), share {100 * rec['share']:.1f} %")
    if not (gap_t <= 1e-5 and gap_in <= 1e-5 and gap_all <= 1e-4
            and rerun):
        raise AssertionError(f"kernel I on lj_melt({n}) outside its bars")
    del eng, args, kw
    torch.cuda.empty_cache()
    return rec


def deck_run(eng, steps):
    """eng.run(steps), thermo every 100 steps; each row with fix bfield's
    energy() and vector() where the deck has the fix."""
    bfield = [f for f in eng.fixes if type(f).__name__ == "FixBfield"]
    rows = []

    def note(row):
        for fix in bfield:
            row["bfield_energy"] = float(fix.energy(eng.state, eng.ctx))
            row["bfield_vector"] = [float(v) for v in fix.vector(eng.state)]
        rows.append(row)

    eng.run(steps, thermo_every=100, on_thermo=note)
    return rows


def deck_path(dev, modules, name, gpu):
    """One deck's main path: DECK_RUN_STEPS through the graph loop with the
    counters reset (D' must launch, and no other kernel), finite thermo and
    bfield output, the state against an eager Engine's bit for bit (fix
    bfield's extras included), both loops' numbers in turns, the forces'
    device time on the run's lists, D' on a rebuild of the run."""
    eng = deck_engine(dev, name)
    natoms = eng.state.natoms
    torch.cuda.reset_peak_memory_stats()
    for m in modules.values():
        m.launches = 0
    t0 = time.perf_counter()
    rows = deck_run(eng, DECK_RUN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {m: mod.launches for m, mod in modules.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rebuilds = eng.rebuilds
    print(f"{name} main run (graph loop): {natoms} atoms, {DECK_RUN_STEPS} "
          f"steps in {wall:.2f} s (plan sizing, capture and thermo rows "
          f"included), launches {launches}, rebuilds {eng.rebuilds}, K "
          f"{dict(eng._plan.k_caps)}, peak memory {peak:.3f} GiB")
    if eng._loop is None or eng._loop.exec is None:
        raise AssertionError(f"the {name} main path did not run through the "
                             "graph")
    check_launches(f"{name} main path", launches, LJ_PATH)
    for r in rows:
        vals = [v for k, v in r.items() if k != "bfield_vector"] \
            + r.get("bfield_vector", [])
        if not all(np.isfinite(v) for v in vals):
            raise AssertionError(f"non-finite {name} thermo row {r}")
        print(f"  step {r['step']} T {r['temp']:.6f} pe {r['pe']:.6f} "
              f"etotal {r['etotal']:.6f} press {r['press']:.4f}"
              + (f" bfield {r['bfield_energy']:.6e} {r['bfield_vector']}"
                 if "bfield_energy" in r else ""))
    if not torch.isfinite(eng.state.x).all() \
            or not torch.isfinite(eng.state.f).all():
        raise AssertionError(f"non-finite {name} positions or forces")
    drift = (abs(rows[-1]["etotal"] - rows[0]["etotal"])
             / (rows[-1]["step"] - rows[0]["step"]) / natoms)
    print(f"{name} NVE drift {drift:.3e} energy units/step/atom (reported, "
          f"no bar)")
    ref = deck_engine(dev, name, fused=False)
    deck_run(ref, DECK_RUN_STEPS)
    same = same_state(eng, ref)
    print(f"{name} graph vs eager loop after {DECK_RUN_STEPS} steps: "
          f"bit-identical {same}, rebuilds {eng.rebuilds} / {ref.rebuilds}")
    if not all(same.values()):
        raise AssertionError(f"the {name} graph loop's state differs from the "
                             "eager loop's")
    numbers = loop_numbers({"graph": eng, "eager": ref}, gpu,
                           steps=DECK_RUN_STEPS,
                           profile_steps=DECK_PROFILE_STEPS,
                           kernels=("select_candidates_kernel",
                                    "ljcut_kernel"))
    st = eng.state
    forces_ms = timed_ms(lambda: eng.pair.forces(st.x, st.type, eng.nbr,
                                                 st.box.h), reps=20)
    rebuild_ms = rebuild_device_ms(eng)
    print(f"{name} forces (kernel I) {forces_ms:.4f} ms on the run's lists; "
          f"a rebuild {rebuild_ms:.4f} ms of device time")
    out = dict(natoms=natoms, k_caps=dict(eng._plan.k_caps),
               ghosts=eng.nbr.ghosts.count, rebuilds_main_run=rebuilds,
               drift_per_step_atom=drift, peak_gib=peak,
               capture_s=eng._loop.capture_s, forces_ms=forces_ms,
               rebuild_device_ms=rebuild_ms,
               launches=launches["select_candidates"],
               ljcut_launches=launches["ljcut"],
               thermo=[{k: r[k] for k in ("step", "temp", "pe", "etotal")}
                       | ({"bfield": [r["bfield_energy"]]
                           + r["bfield_vector"]} if "bfield_energy" in r
                          else {}) for r in rows],
               **numbers)
    del ref
    torch.cuda.empty_cache()
    out["select_candidates"] = candidates_record(eng, name)
    del eng
    torch.cuda.empty_cache()
    return out


def phase7_bfield(dev, modules):
    """Config 2 and the LJ styles: the cyclotron oracle, f32 forces of both
    LJ styles, kernel I at LJCUT_SIZES, the charged melt and in.lj main
    paths.  Returns D''s records of the two decks and the oracle (launches
    included) and kernel I's record (its launches on the two decks)."""
    gpu = sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader")
    free_card("phase 7")
    with timed("phase 7 cyclotron oracle"):
        cyclotron = cyclotron_oracle(dev, modules)
    with timed("phase 7 f32 forces"):
        accuracy = ljcut_f32_accuracy(dev)
    with timed("phase 7 kernel I"):
        kernel_i = {f"lj_melt({n})": ljcut_kernel_record(dev, n)
                    for n in LJCUT_SIZES}
    paths = {}
    for name in DECKS:
        with timed(f"phase 7 {name}"):
            paths[name] = deck_path(dev, modules, name, gpu)
    print("BFIELD " + json.dumps(dict(gpu=gpu, cyclotron=cyclotron,
                                      f32_force_err_over_rms=accuracy,
                                      ljcut_forces=kernel_i, **paths)))
    kernel_i["launches"] = sum(paths[name]["ljcut_launches"]
                               for name in DECKS)
    paths["cyclotron"] = cyclotron
    return ({name: dict(p["select_candidates"], launches=p["launches"])
             for name, p in paths.items()}, kernel_i)


#: config 4 (BASELINE.json configs[3]): the MoS2 monolayer at 1,000,518
#: atoms, REBOMOS NVT (benchmarks/bench_monolayer.py:68-80; skin from
#: BENCH_monolayer.json), 300 K from seed 12345, a check every 10 steps
MONO = dict(nx=577, ny=578, skin=0.8, check_every=10, temp=300.0,
            seed=12345, t_damp=0.1)
MONO_RUN_STEPS = 100


def mono_engine(dev, fused=None):
    """The monolayer on the card (f32) with its NVT velocities and fix; no
    lists yet; fused as in aeam_engine."""
    from lammps_plugins_tpu_torch.api.scenes import rebomos_monolayer
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nvt import FixNVT
    from lammps_plugins_tpu_torch.fixes.velocity import velocity_create
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    from lammps_plugins_tpu_torch.run.simulation import Engine
    state = rebomos_monolayer(MONO["nx"], MONO["ny"], dtype=torch.float32,
                              device=dev)
    state = velocity_create(state, units.METAL, MONO["temp"], MONO["seed"])
    pair = REBOMoS.from_file(REBO_FILE, ["M", "S"], dtype=torch.float32,
                             device=dev)
    eng = Engine(state, pair, [FixNVT(MONO["temp"], MONO["temp"],
                                      MONO["t_damp"])], units.METAL,
                 check_every=MONO["check_every"], skin=MONO["skin"])
    eng.fused_loop = fused
    return eng


def mirror_at_run_k(eng):
    """Kernel B against its twin on the REBO cotangents of the run's own
    lists (bar 1e-5 x scale), its time and bound."""
    from lammps_plugins_tpu_torch.ops import mirror, rebo
    pair, st, nbr = eng.pair, eng.state, eng.nbr
    rl = nbr.lists["rebo"]
    planes = pair._rebo_planes(st.x, pair.el_of_type[st.type], nbr.ghosts,
                               rl, st.box.h)
    gk = rebo.rebo_cotangents(*planes, pair._rebo_consts)
    del planes
    mv = rl.mirvT.float()
    fk = mirror.mirror_combine(*gk, rl.mirT, mv)
    ft = mirror.mirror_combine_ref(*gk, rl.mirT, mv)
    err = float((fk - ft).abs().max())
    K, Np = rl.mirT.shape
    b_ms, b_by = bound(4 * 5 * K * Np + 4 * fk.numel(), 6 * K * Np)
    out = dict(K=K, Np=Np, max_abs_err=err, bar=1e-5 * float(ft.abs().max()),
               ms=timed_ms(lambda: mirror.mirror_combine(*gk, rl.mirT, mv)),
               plain_ms=timed_ms(lambda: mirror.mirror_combine_ref(
                   *gk, rl.mirT, mv), reps=3), bound_ms=b_ms, bound_by=b_by,
               max_mirror_index=int(rl.mirT.max()))
    print(f"mirror_combine at the run's K={K}, Np={Np}: max_abs_err={err:.3e} "
          f"(bar {out['bar']:.3e}) kernel {out['ms']:.4f} ms, twin "
          f"{out['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by {b_by}; "
          f"largest mirror index {out['max_mirror_index']} (int32)")
    if not err <= out["bar"]:
        raise AssertionError("mirror_combine disagrees with its twin at the "
                             "monolayer's size")
    return out


#: bytes of the LJ twin's [cells, C, C] temporaries (~16 floats a slot
#: pair) allowed for one slab of A cells along x
LJ_TWIN_SLAB_BYTES = 2 ** 32


def lj_cells_at_run(eng):
    """Kernel C against its twin on the run's own cell planes (forces 2e-4
    x scale, energy 2e-5 relative; reruns bit-identical), its time and
    bound.  The twin runs slab by slab of A cells along x (same sums, less
    memory); the A cells without an owned atom are counted."""
    from lammps_plugins_tpu_torch.ops import lj_cells
    pair, st, nbr = eng.pair, eng.state, eng.nbr
    P = pair._cell_planes(st.x, nbr.ghosts, nbr.cells, st.box.h)
    ar, lc = nbr.cells.a_range, pair._lj_consts
    (x0, x1), ay, az = ar
    C = P.shape[-1]
    per_x = (ay[1] - ay[0]) * (az[1] - az[0]) * C * C * 4 * 16
    step = max(1, LJ_TWIN_SLAB_BYTES // per_x)
    slabs = [((a, min(a + step, x1)), ay, az) for a in range(x0, x1, step)]
    ok = lj_cells.lj_cell_forces(P, lc, ar, with_energy=True)
    if not torch.equal(ok, lj_cells.lj_cell_forces(P, lc, ar,
                                                   with_energy=True)):
        raise AssertionError("lj_cell_forces reruns differ at the run's size")
    err = scale = et = 0.0
    npairs = 0
    for s in slabs:
        ot = lj_cells.lj_cell_forces_ref(P, lc, s, with_energy=True)
        ks = ok[s[0][0] - x0:s[0][1] - x0]
        err = max(err, float((ks[..., :3, :] - ot[..., :3, :]).abs().max()))
        scale = max(scale, float(ot[..., :3, :].abs().max()))
        et += float(ot[..., 3, :].double().sum())
        npairs += lj_window_pairs(P, lc, s)
        del ot, ks
    ek = float(ok[..., 3, :].double().sum())
    A = P[x0:x1, ay[0]:ay[1], az[0]:az[1]]
    empty = int((~(A[..., 4, :] > 0).any(dim=-1)).sum())
    b_ms, b_by = bound(4 * (P.numel() + ok.numel()), 30 * npairs)
    out = dict(dims=list(P.shape[:3]), a_range=[list(r) for r in ar], C=C,
               a_cells_without_owned_atoms=empty,
               a_cells=int(np.prod(A.shape[:3])), twin_slabs=len(slabs),
               max_abs_err=err, bar=2e-4 * scale,
               energy_rel_err=abs(ek - et) / abs(et), energy_bar=2e-5,
               window_pairs=npairs,
               ms=timed_ms(lambda: lj_cells.lj_cell_forces(P, lc, ar),
                           reps=20),
               plain_ms=timed_ms(lambda: [lj_cells.lj_cell_forces_ref(
                   P, lc, s) for s in slabs], reps=3),
               bound_ms=b_ms, bound_by=b_by, reruns_bit_identical=True)
    print(f"lj_cell_forces on the run's cells {out['dims']} (C={C}, "
          f"{empty} of {out['a_cells']} A cells without an owned atom): "
          f"max_abs_err={err:.3e} (bar {out['bar']:.3e}), energy rel "
          f"{out['energy_rel_err']:.3e} (bar 2e-5), kernel {out['ms']:.4f} "
          f"ms, twin {out['plain_ms']:.4f} ms ({len(slabs)} slabs), bound "
          f"{b_ms:.4f} ms by {b_by}, window pairs {npairs}")
    if not (err <= out["bar"] and out["energy_rel_err"] <= 2e-5):
        raise AssertionError("lj_cell_forces disagrees with its twin at the "
                             "monolayer's size")
    out["with_virial"] = lj_virial_record(P, lc, ar, ok, npairs,
                                          slabs=slabs, plain=False)
    return out


def phase8_monolayer(dev, modules):
    """The 1,000,518-atom monolayer, REBOMOS NVT: the main path through the
    graph loop (A, B, C and D' must launch), the NVT conserved quantity's
    drift, the state against an eager Engine's bit for bit, A, B and C
    against their twins on the run's lists and cells, D' exact against its
    twin and the rebuild at this size, both
    loops' numbers.  Returns ({kernel module: launches}, {record})."""
    gpu = sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader")
    free_card("phase 8")
    t0 = time.perf_counter()
    eng = mono_engine(dev)
    natoms = eng.state.natoms
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    for m in modules.values():
        m.launches = 0
    t0 = time.perf_counter()
    rows = nvt_run(eng, MONO_RUN_STEPS, MONO_RUN_STEPS // 2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: m.launches for name, m in modules.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rebuilds = eng.rebuilds
    print(f"monolayer main run (graph loop): {natoms} atoms (scene and "
          f"Engine {setup_s:.2f} s), {MONO_RUN_STEPS} steps in {wall:.2f} s "
          f"(the first rebuild, plan sizing, capture and thermo rows "
          f"included), launches {launches}, rebuilds {eng.rebuilds}, K "
          f"{dict(eng._plan.k_caps)}, ghosts {eng.nbr.ghosts.count}, peak "
          f"memory {peak:.3f} GiB, memory_usage {eng.memory_usage()}")
    if eng._loop is None or eng._loop.exec is None:
        raise AssertionError("the monolayer did not run through the graph")
    check_launches("monolayer", launches, MAIN_PATH)
    for r in rows:
        if not all(np.isfinite(v) for v in r.values()):
            raise AssertionError(f"non-finite monolayer thermo row {r}")
        print(f"  step {r['step']} T {r['temp']:.4f} pe {r['pe']:.6f} "
              f"conserved {r['conserved']:.6f} press {r['press']:.3f}")
    drift = (abs(rows[-1]["conserved"] - rows[0]["conserved"])
             / (rows[-1]["step"] - rows[0]["step"]) / natoms)
    print(f"monolayer NVT conserved-quantity drift {drift:.3e} eV/step/atom "
          f"(bar 1e-6)")
    if not drift < 1e-6:
        raise AssertionError("monolayer NVT drift above 1e-6 eV/step/atom")
    rebo_k = rebo_at_run_k(eng)
    mirror_k = mirror_at_run_k(eng)
    torch.cuda.empty_cache()
    lj_run = lj_cells_at_run(eng)
    torch.cuda.empty_cache()
    ref = mono_engine(dev, fused=False)
    nvt_run(ref, MONO_RUN_STEPS, MONO_RUN_STEPS // 2)
    same = same_state(eng, ref)
    print(f"monolayer graph vs eager loop after {MONO_RUN_STEPS} steps: "
          f"bit-identical {same}, rebuilds {eng.rebuilds} / {ref.rebuilds}")
    if not all(same.values()):
        raise AssertionError("the monolayer graph loop's state differs from "
                             "the eager loop's")
    numbers = loop_numbers({"graph": eng, "eager": ref}, gpu,
                           steps=MONO_RUN_STEPS, profile_steps=MONO_RUN_STEPS)
    peak_both = torch.cuda.max_memory_allocated() / 2 ** 30
    del ref
    torch.cuda.empty_cache()
    rebuild_ms = rebuild_device_ms(eng)
    cand = candidates_record(eng, "monolayer")
    print(f"monolayer: a rebuild {rebuild_ms:.3f} ms of device time, D' "
          f"{cand['ms']:.4f} ms of it")
    out = dict(gpu=gpu, natoms=natoms, k_caps=dict(eng._plan.k_caps),
               ghosts=eng.nbr.ghosts.count, rebuilds_main_run=rebuilds,
               nvt_drift_ev_per_step_atom=drift, peak_gib_graph_run=peak,
               peak_gib_both_loops=peak_both, capture_s=eng._loop.capture_s,
               rebuild_device_ms=rebuild_ms, rebo_at_run_k=rebo_k,
               mirror_at_run_k=mirror_k, lj_cells_at_run=lj_run,
               select_candidates=cand,
               launches={KERNEL_NAMES[m]: launches[m] for m in MAIN_PATH},
               **numbers)
    print("MONOLAYER " + json.dumps(out))
    del eng
    torch.cuda.empty_cache()
    return launches, out


# -- phase 9: decks through the port's input-script interpreter ------------

#: the in.rebomos-bulk deck text (lattice custom with $(...) basis, the
#: tilted prism, the masses of in.rebomos-bulk:24-25; api/scenes.py's
#: MOS2_* constants) with the synthetic parameters; `replicate 17 4 5`
#: makes 340 x 288 = 97,920 atoms, the bench scene's count
REBO_DECK = """
units           metal
atom_style      atomic
boundary        p p p
lattice custom 1.0 a1 3.1903157234 0.0 0.0 a2 -1.5964590311 2.7651481541 0.0 &
        a3 0.0 0.0 13.9827680588 &
        basis 0.0 0.0 $(3.0/4.0) basis 0.0 0.0 $(1.0/4.0) &
        basis $(2.0/3.0) $(1.0/3.0) 0.862008989 &
        basis $(1.0/3.0) $(2.0/3.0) 0.137990996 &
        basis $(1.0/3.0) $(2.0/3.0) 0.362008989 &
        basis $(2.0/3.0) $(1.0/3.0) 0.637991011 origin 0.1 0.1 0.1
region          box prism 0 4 0 8 0 1 -2.0 0 0
create_box      2 box
create_atoms    1 box basis 1 1 basis 2 1 basis 3 2 basis 4 2 basis 5 2 basis 6 2
replicate       17 4 5
mass            1 95.95
mass            2 32.065
pair_style      rebomos
pair_coeff      * * {rebo} M S
neighbor        0.8 bin
velocity        all create 300.0 12345
fix             1 all nve
{outputs}thermo          100
"""
REBO_OUTPUTS = """compute         pe all pe/atom
compute         s all stress/atom NULL
dump            1 all custom {dump_every} {dir}/mos.dump.{tag} id type x y z c_pe c_s[1] c_s[2] c_s[3] c_s[4] c_s[5] c_s[6]
restart         {restart_every} {dir}/mos.restart.*
"""
REBO_RESTART_DECK = """
units           metal
atom_style      atomic
boundary        p p p
read_restart    {path}
pair_style      rebomos
pair_coeff      * * {rebo} M S
neighbor        0.8 bin
fix             1 all nve
thermo          10
run             10
"""
#: USER-AEAM/sample.in at full width (32,000 atoms; scenes.alsi_sample and
#: benchmarks/bench_aeam.py, phase 6's settings: skin 1.2, a check every
#: 12 steps, 863 K from seed 4928459, the masses of alsi_sample)
SAMPLE_DECK = """
units           metal
atom_style      atomic
boundary        p p p
lattice         fcc 4.045
region          box block 0 20 0 20 0 20
create_box      2 box
create_atoms    1 box
set             group all type/fraction 2 0.0075 7683797
mass            1 27.0
mass            2 28.0
pair_style      aeam
pair_coeff      * * {aeam} Al Si
velocity        all create 863.0 4928459
neighbor        1.2 bin
neigh_modify    every 12 delay 0 check yes
timestep        0.001
fix             1 all nvt temp 863.0 {t_stop} 0.1
thermo          12
"""
SAMPLE_STEPS = 96
#: the ramped deck's end point (phase 9 (b): two runs of SAMPLE_STEPS)
SAMPLE_RAMP_T = 900.0
#: LAMMPS bench/in.lj (32,000 atoms) from a data file of the lattice with
#: every atom moved by 0.05 sigma (normal, numpy seed 7), so that FIRE has
#: work to do; fix langevin and fix nve are defined before minimize (FIRE
#: ignores them) and drive the run after it
LJ_DECK = """
units           lj
atom_style      atomic
read_data       {path}
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
fix             1 all langevin 1.44 1.44 0.1 48279
fix             2 all nve
thermo          100
min_style       fire
"""
LJ_MINIMIZE = "minimize 0.0 1e-4 200 2000"
LJ_RUN_STEPS = 300
#: the Langevin step's timed windows (graph loop, capture excluded), in
#: turns with in.lj's plain NVE step (phase 7's Engine)
LJ_TIMED_STEPS, LJ_TIMED_REPS = 500, 3
#: the REBOMOS deck's run, dump and restart intervals (phase 9 (a))
REBO_STEPS, REBO_DUMP_EVERY, REBO_RESTART_EVERY = 1000, 250, 500
#: |pressure of Σ vatom - thermo press| over the pressure tensor's largest
#: component, f32 on the card: at most 7.0e-6 (frame 250) on an NVIDIA
#: H100 80GB HBM3 at 700.00 W, in each of two runs of this script; the bar
#: leaves a factor of ~7
PRESS_BAR = 5e-5
SCRIPT_DIR = os.path.join(REPO, "build", "chip_smoke_script")


def check_graph(label, eng):
    """The Engine ran through the device loop's captured graph."""
    if eng._loop is None or eng._loop.exec is None:
        raise AssertionError(f"{label} did not run through the graph loop")


def card_script(text, fused=None):
    """The port's Script on the card (float32, its defaults) after `text`;
    fused sets its Engine's loop (None: the graph loop) once one exists."""
    from lammps_plugins_tpu_torch.api.script import Script
    s = Script(log=lambda _: None)
    s.run_text(text)
    if s.engine is not None:
        s.engine.fused_loop = fused
    return s


def run_counted(s, steps, modules):
    """(rows, launches by module, wall s) of the Script's `run steps`,
    every counter set to 0 just before it."""
    for m in modules.values():
        m.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = s.cmd_run([str(steps)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return rows, {name: m.launches for name, m in modules.items()}, wall


@contextlib.contextmanager
def plain_kernels():
    """Kernels A, B and C swapped for their plain-PyTorch twins where the
    REBOMoS per-atom tallies call them (potentials/rebomos.py, base.py), so
    that the same code runs on the same card tensors with no kernel."""
    from lammps_plugins_tpu_torch.ops import lj_cells, mirror, rebo
    from lammps_plugins_tpu_torch.potentials import base, rebomos
    swaps = [(rebomos, "rebo_cotangents", rebo.rebo_cotangents_ref),
             (rebomos, "lj_cell_forces", lj_cells.lj_cell_forces_ref),
             (base, "mirror_combine", mirror.mirror_combine_ref)]
    saved = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    for m, name, fn in swaps:
        setattr(m, name, fn)
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def plain_peratom(s, state, modules):
    """(eatom, the stress/atom columns) of the frame's state through the
    kernels' twins (plain_kernels), on the same card tensors; no kernel
    may launch."""
    from lammps_plugins_tpu_torch.potentials.base import VIRIAL_PAIRS
    eng = s.engine
    before = {name: m.launches for name, m in modules.items()}
    with plain_kernels(), torch.no_grad():
        e = eng.pair.energy_peratom(state.x, state.type, eng.nbr,
                                    state.box.h)
        vat = eng.pair.virial_peratom(state.x, state.type, eng.nbr,
                                      state.box.h)
    torch.cuda.synchronize()
    if {name: m.launches for name, m in modules.items()} != before:
        raise AssertionError("a kernel launched in the plain per-atom path")
    m, v, u = state.per_atom_mass, state.v, s.units
    kin = u.mvv2e * torch.stack([m * v[:, a] * v[:, b]
                                 for a, b in VIRIAL_PAIRS], dim=1)
    return e, -(kin + vat) * u.nktv2p


def watch_frames(s, modules):
    """Wrap the deck's pe/atom and stress/atom providers: at each dump
    frame record the step, Σ pe/atom against the frame's pe (float64 sum
    of the f32 values; pe from the pair style's energy), the pressure of
    Σ vatom against the thermo row's, kernel C's launches inside the
    frame's pe/atom, and pe/atom and the six stress/atom columns atom by
    atom against the kernels' twins on the same state (plain_peratom:
    bars 1e-4 and 5e-4 of their scale, the card test's)."""
    from lammps_plugins_tpu_torch.run.dump import DumpWriter
    writer = [w for _, w in s.dumps if isinstance(w, DumpWriter)][0]
    frames, pending = [], {}
    pe_fn, s1_fn = writer.providers["c_pe"], writer.providers["c_s[1]"]

    def pe_probe(state):
        c0 = modules["lj_cells"].launches
        out = pe_fn(state)
        c1 = modules["lj_cells"].launches
        eng = s.engine
        with torch.no_grad():
            pe = float(eng.pair.energy(state.x, None, state.type, eng.nbr,
                                       state.box.h))
        e_plain, pending["stress"] = plain_peratom(s, state, modules)
        frames.append(dict(step=state.step, lj_energy_launches=c1 - c0,
                           sum_pe_atom=float(out.double().sum()), pe=pe,
                           pe_atom_max_abs_err=float(
                               (out - e_plain).abs().max()),
                           pe_atom_scale=float(e_plain.abs().max())))
        return out

    def s1_probe(state):
        out = s1_fn(state)
        eng = s.engine
        stress = torch.stack([s.computes[f"c_s[{k}]"](state)
                              for k in range(1, 7)], dim=1)
        vol = abs(float(np.linalg.det(state.box.h_np())))
        p_atom = -float(stress[:, :3].double().sum()) / (3.0 * vol)
        row = eng._thermo(state)
        scale = max(abs(row[k]) for k in ("pxx", "pyy", "pzz", "pxy", "pxz",
                                           "pyz"))
        s_plain = pending.pop("stress")
        frames[-1].update(
            press_from_vatom=p_atom, press=row["press"], press_scale=scale,
            stress_atom_max_abs_err=float((stress - s_plain).abs().max()),
            stress_atom_scale=float(s_plain.abs().max()))
        return out

    writer.providers["c_pe"], writer.providers["c_s[1]"] = pe_probe, s1_probe
    return frames


def unwrapped(eng):
    st = eng.state
    return st.box.unmap(st.x, st.image).double().cpu().numpy()


def wall_ms(fns, reps=3):
    """Median wall ms (synchronised) of each callable in `fns` (name ->
    fn), one call each per turn, the order reversed every other turn,
    after one call each to warm up."""
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    names = list(fns)
    for rep in range(reps):
        for name in (names if rep % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
    return {name: statistics.median(t) for name, t in times.items()}


def output_parts_ms(eng, reps=3):
    """Wall ms (synchronised; medians of `reps` in turns) on the Engine's
    final state of one thermo row (kernels A and C, no autograd) and of the
    row through the strain autograd it replaced (the yardstick), pe/atom
    and the per-atom virial; and the device ms of the thermo row's C
    launch (forces, energy and virial rows)."""
    from lammps_plugins_tpu_torch.ops import lj_cells
    from lammps_plugins_tpu_torch.potentials.base import PairStyle
    from lammps_plugins_tpu_torch.run.thermo import thermo_row
    st, pair, nbr = eng.state, eng.pair, eng.nbr

    def autograd_row():
        pe, w = PairStyle.energy_virial(pair, st.x, st.type, nbr, st.box.h)
        return thermo_row(st, pe, w, eng.units)

    out = wall_ms({"thermo_row": lambda: eng._thermo(st),
                   "thermo_row_autograd": autograd_row}, reps)
    out.update(wall_ms({"energy_peratom": lambda: pair.energy_peratom(
        st.x, st.type, nbr, st.box.h), "virial_peratom":
        lambda: pair.virial_peratom(st.x, st.type, nbr, st.box.h)}, reps))
    P = pair._cell_planes(st.x, nbr.ghosts, nbr.cells, st.box.h)
    out["lj_cells_energy_virial_device_ms"] = timed_ms(
        lambda: lj_cells.lj_cell_forces(P, pair._lj_consts,
                                        nbr.cells.a_range, with_energy=True,
                                        with_virial=True), reps=20)
    return out


#: a thermo row on the card against the strain autograd on the same card
#: tensors: pe relative, W of max|W|
THERMO_PE_BAR, THERMO_W_BAR = 2e-5, 5e-4


@contextlib.contextmanager
def watch_thermo(modules, rows, yardstick=True):
    """REBOMoS.energy_virial wrapped for every thermo row taken inside the
    block: the A, B and C launches of the row and whether autograd was on
    at them, appended to `rows`; with yardstick, also (pe, W) against the
    strain autograd it replaced on the same card tensors
    (PairStyle.energy_virial, which launches no kernel)."""
    from lammps_plugins_tpu_torch.potentials.base import PairStyle
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    real = REBOMoS.energy_virial
    names = ("rebo", "lj_cells", "mirror")

    def probe(pair, x, types, nbr, h, center_mask=None):
        c0 = {m: modules[m].launches for m in names}
        grad = []
        with spy_grad(grad):
            e, w = real(pair, x, types, nbr, h, center_mask)
        row = dict(launches={m: modules[m].launches - c0[m] for m in names},
                   grad_enabled=any(grad), pe=float(e))
        if yardstick:
            ea, wa = PairStyle.energy_virial(pair, x, types, nbr, h,
                                             center_mask=center_mask)
            row.update(pe_autograd=float(ea),
                       pe_rel_err=abs(float(e - ea)) / abs(float(ea)),
                       w_err_of_max=float((w - wa).abs().max())
                       / float(wa.abs().max()))
        rows.append(row)
        return e, w

    REBOMoS.energy_virial = probe
    try:
        yield rows
    finally:
        REBOMoS.energy_virial = real


@contextlib.contextmanager
def spy_grad(seen):
    """Record torch.is_grad_enabled() at each launch of A and C made
    through potentials/rebomos.py inside the block."""
    from lammps_plugins_tpu_torch.potentials import rebomos
    saved = {n: getattr(rebomos, n) for n in ("rebo_cotangents",
                                              "lj_cell_forces")}

    def wrap(fn):
        def spy(*a, **k):
            seen.append(torch.is_grad_enabled())
            return fn(*a, **k)
        return spy

    for n, fn in saved.items():
        setattr(rebomos, n, wrap(fn))
    try:
        yield seen
    finally:
        for n, fn in saved.items():
            setattr(rebomos, n, fn)


@contextlib.contextmanager
def refuse_plain():
    """Every twin of A, B and C, the 27-offset LJ sweeps of the twins and
    the energy, and torch.autograd.grad raise inside the block."""
    from lammps_plugins_tpu_torch.ops import lj_cells, mirror, rebo
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS

    def refuse(*_, **__):
        raise AssertionError("a plain path ran on the card")

    swaps = [(rebo, "rebo_cotangents_ref"), (lj_cells, "lj_cell_forces_ref"),
             (lj_cells, "pair_terms"), (mirror, "mirror_combine_ref"),
             (REBOMoS, "_lj_energy_cells"), (torch.autograd, "grad")]
    saved = [(m, n, getattr(m, n)) for m, n in swaps]
    for m, n in swaps:
        setattr(m, n, refuse)
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def check_thermo_rows(label, rows):
    """Each watched row launched A and C once, B never, with autograd off,
    and, where it was held to the autograd path, sits within the bars."""
    if not rows:
        raise AssertionError(f"{label}: no thermo row was taken")
    for r in rows:
        if r["launches"] != {"rebo": 1, "lj_cells": 1, "mirror": 0} \
                or r["grad_enabled"]:
            raise AssertionError(f"{label}: a thermo row launched "
                                 f"{r['launches']} (grad on: "
                                 f"{r['grad_enabled']}), not A and C once "
                                 f"each under no_grad")
        if "pe_rel_err" in r and not (r["pe_rel_err"] <= THERMO_PE_BAR
                                      and r["w_err_of_max"] <= THERMO_W_BAR):
            raise AssertionError(f"{label}: a thermo row is off the "
                                 f"autograd path: {r}")


def thermo_path(eng, modules):
    """This slice's path on the deck's Engine at its final state, its
    counters set to 0 just before and read just after: one thermo row and
    one stress/atom (A and C must launch), under refuse_plain (no twin, no
    autograd); then the same energy_virial with A, B and C swapped for
    their twins (plain_kernels) launches nothing and agrees with it."""
    st, pair, nbr = eng.state, eng.pair, eng.nbr
    for m in modules.values():
        m.launches = 0
    rows = []
    with refuse_plain(), watch_thermo(modules, rows, yardstick=False):
        eng._thermo(st)
        pair.virial_peratom(st.x, st.type, nbr, st.box.h)
    torch.cuda.synchronize()
    launches = {name: m.launches for name, m in modules.items()}
    check_launches("thermo path", launches, ("rebo", "mirror", "lj_cells"))
    check_thermo_rows("thermo path", rows)
    e, w = pair.energy_virial(st.x, st.type, nbr, st.box.h)
    for m in modules.values():
        m.launches = 0
    with plain_kernels():
        ep, wp = pair.energy_virial(st.x, st.type, nbr, st.box.h)
    torch.cuda.synchronize()
    plain_launches = sum(m.launches for m in modules.values())
    pe_err = abs(float(e - ep)) / abs(float(ep))
    w_err = float((w - wp).abs().max()) / float(wp.abs().max())
    print(f"thermo path: a thermo row and a stress/atom frame launched "
          f"{ {k: v for k, v in launches.items() if v} } with every twin "
          f"and torch.autograd.grad refused; energy_virial through the "
          f"twins (plain_kernels) launched {plain_launches} kernels, pe rel "
          f"{pe_err:.3e} (bar {THERMO_PE_BAR}), W {w_err:.3e} of max|W| "
          f"(bar {THERMO_W_BAR}) against the kernels")
    if plain_launches or not (pe_err <= THERMO_PE_BAR
                              and w_err <= THERMO_W_BAR):
        raise AssertionError("energy_virial through the twins launched a "
                             "kernel or disagrees with the kernels")
    return dict(launches=launches, plain_launches=plain_launches,
                plain_pe_rel_err=pe_err, plain_w_err_of_max=w_err)


def script_rebomos(dev, modules):
    """(a) the REBOMOS deck at the bench width: 1,000 steps with per-atom
    computes, dumps every 250 and restarts every 500 (twice: byte-identical
    dumps), the same deck without them (the same thermo rows bit for bit),
    and read_restart of the step-500 file plus 10 steps against the
    uninterrupted run at step 510."""
    from lammps_plugins_tpu_torch.run.dump import DumpWriter
    gpu = sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader")
    out = {}
    dumps, rows, walls, timers = [], [], [], []
    for tag in ("a", "b"):
        outputs = REBO_OUTPUTS.format(dir=SCRIPT_DIR, tag=tag,
                                      dump_every=REBO_DUMP_EVERY,
                                      restart_every=REBO_RESTART_EVERY)
        s = card_script(REBO_DECK.format(rebo=REBO_FILE, outputs=outputs))
        # the first run checks each frame (its probes cost time); the
        # second is the timed one
        frames = watch_frames(s, modules) if tag == "a" else None
        torch.cuda.reset_peak_memory_stats()
        if tag == "a":
            # every thermo row of the run (the deck's and the frames')
            # held to the strain autograd on the same card tensors
            with watch_thermo(modules, []) as thermo_rows:
                r, launches, wall = run_counted(s, REBO_STEPS, modules)
            check_thermo_rows("REBOMOS deck", thermo_rows)
        else:
            r, launches, wall = run_counted(s, REBO_STEPS, modules)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        eng = s.engine
        check_graph("REBOMOS deck", eng)
        writer = [w for _, w in s.dumps if isinstance(w, DumpWriter)][0]
        writer.close()
        dumps.append(writer)
        timers.append(dict(eng.timers.acc))
        rows.append(r)
        walls.append(wall)
        if tag == "a":
            out.update(natoms=eng.state.natoms, launches_with_outputs={
                KERNEL_NAMES[m]: launches[m] for m in MAIN_PATH},
                frames=frames, peak_gib_with_outputs=peak,
                rebuilds=eng.rebuilds, thermo_rows=thermo_rows,
                thermo_bars=dict(pe_rel=THERMO_PE_BAR,
                                 w_of_max=THERMO_W_BAR))
            check_launches("REBOMOS deck", launches, MAIN_PATH)
            run_a = launches
        del s, eng
        torch.cuda.empty_cache()
    natoms = out["natoms"]
    print(f"REBOMOS deck through Script on {gpu}: {natoms} atoms, "
          f"{REBO_STEPS} steps, launches {run_a}, rebuilds "
          f"{out['rebuilds']}")
    tr = out["thermo_rows"]
    print(f"  {len(tr)} thermo rows (the deck's and the frames'), each A "
          f"and C once under no_grad, against the strain autograd on the "
          f"same tensors: pe rel at most "
          f"{max(r['pe_rel_err'] for r in tr):.3e} (bar {THERMO_PE_BAR}), "
          f"W at most {max(r['w_err_of_max'] for r in tr):.3e} of max|W| "
          f"(bar {THERMO_W_BAR})")
    for f in out["frames"]:
        f["press_off_of_scale"] = (abs(f["press_from_vatom"] - f["press"])
                                   / f["press_scale"])
        print(f"  frame {f['step']}: sum pe/atom {f['sum_pe_atom']:.6f} pe "
              f"{f['pe']:.6f}; press from vatom "
              f"{f['press_from_vatom']:.6f} thermo {f['press']:.6f} "
              f"(tensor scale {f['press_scale']:.3f}, off by "
              f"{f['press_off_of_scale']:.2e} of it); kernel C launches in "
              f"pe/atom {f['lj_energy_launches']}; atom by atom against the "
              f"twins: "
              f"pe/atom {f['pe_atom_max_abs_err']:.3e} (bar "
              f"{1e-4 * f['pe_atom_scale']:.3e}), stress/atom "
              f"{f['stress_atom_max_abs_err']:.3e} (bar "
              f"{5e-4 * f['stress_atom_scale']:.3e})")
    steps = [f["step"] for f in out["frames"]]
    if steps != list(range(0, REBO_STEPS + 1, REBO_DUMP_EVERY)):
        raise AssertionError(f"dump frames {steps}")
    for f in out["frames"]:
        if not abs(f["sum_pe_atom"] - f["pe"]) <= 1e-5 * abs(f["pe"]):
            raise AssertionError(f"sum pe/atom off pe at step {f['step']}")
        if not f["press_off_of_scale"] <= PRESS_BAR:
            raise AssertionError(f"pressure of sum vatom off press at "
                                 f"step {f['step']}")
        if f["lj_energy_launches"] != 1:
            raise AssertionError("pe/atom did not read kernel C's energy "
                                 "row")
        if not (f["pe_atom_max_abs_err"] <= 1e-4 * f["pe_atom_scale"]
                and f["stress_atom_max_abs_err"]
                <= 5e-4 * f["stress_atom_scale"]):
            raise AssertionError(f"pe/atom or stress/atom off the kernels' "
                                 f"twins atom by atom at step {f['step']}")
    same_dump = (open(dumps[0].path, "rb").read()
                 == open(dumps[1].path, "rb").read())
    if not same_dump or rows[0] != rows[1]:
        raise AssertionError("a second run of the REBOMOS deck wrote other "
                             "dump bytes or other thermo rows")
    frame_ms = {k: 1e3 * v / dumps[1].frames
                for k, v in timers[1].items() if k.startswith("Output.dump.")}
    # the same deck without its compute, dump and restart lines
    s = card_script(REBO_DECK.format(rebo=REBO_FILE, outputs=""))
    torch.cuda.reset_peak_memory_stats()
    r_plain, launches_plain, wall_plain = run_counted(s, REBO_STEPS,
                                                      modules)
    peak_plain = torch.cuda.max_memory_allocated() / 2 ** 30
    if r_plain != rows[0]:
        bad = [(a["step"], b["step"]) for a, b in zip(r_plain, rows[0])
               if a != b]
        raise AssertionError(f"thermo rows differ with and without the "
                             f"outputs at {bad[:3]}")
    parts_ms = output_parts_ms(s.engine)
    thermo = thermo_path(s.engine, modules)
    del s
    # uninterrupted run to 10 steps past the first restart file, and the
    # resume from that file
    s = card_script(REBO_DECK.format(rebo=REBO_FILE, outputs=""))
    s.command(f"run {REBO_RESTART_EVERY + 10}")
    x_ref = unwrapped(s.engine)
    del s
    r = card_script(REBO_RESTART_DECK.format(path=os.path.join(
        SCRIPT_DIR, f"mos.restart.{REBO_RESTART_EVERY}"), rebo=REBO_FILE))
    if r.engine.state.step != REBO_RESTART_EVERY + 10:
        raise AssertionError(f"resumed run ends at step "
                             f"{r.engine.state.step}")
    resume_dx = float(np.abs(unwrapped(r.engine) - x_ref).max())
    print(f"restart at step {REBO_RESTART_EVERY} + 10 steps: max |dx| "
          f"{resume_dx:.3e} A from the uninterrupted run (bar 1e-3)")
    if not resume_dx < 1e-3:
        raise AssertionError("the resumed run left the uninterrupted one")
    del r
    torch.cuda.empty_cache()
    with_dumps = natoms * REBO_STEPS / walls[1]
    without = natoms * REBO_STEPS / wall_plain
    print(f"REBOMOS deck: atom-steps/s over {REBO_STEPS} steps "
          f"{with_dumps:.6g} with the dumps ({dumps[1].frames} frames, "
          f"{REBO_STEPS // REBO_RESTART_EVERY} restart files), "
          f"{without:.6g} "
          f"without; ms per dump frame {frame_ms}; ms of one thermo row "
          f"(and through the strain autograd), pe/atom, the per-atom "
          f"virial, and the device ms of the row's C launch {parts_ms}; "
          f"peak memory "
          f"{out['peak_gib_with_outputs']:.3f} GiB with outputs, "
          f"{peak_plain:.3f} GiB without; thermo rows equal with and "
          f"without outputs, dump reruns byte-identical")
    out.update(atom_steps_per_s_with_dumps=with_dumps,
               atom_steps_per_s_without=without,
               wall_s_with_dumps=walls, wall_s_without=wall_plain,
               ms_per_dump_frame=frame_ms, output_parts_ms=parts_ms,
               thermo_path=thermo,
               peak_gib_without=peak_plain,
               resume_max_dx_A=resume_dx, rows_equal_without_outputs=True,
               dump_reruns_identical=True,
               press_bar_of_tensor_scale=PRESS_BAR, sum_pe_bar=1e-5)
    return out, run_a


def script_sample(dev, modules):
    """(b) sample.in at full width: 96 steps equal to phase 6's Engine
    (aeam_engine) bit for bit; then the deck with its fix ramping 863 ->
    900 K run twice for 96 steps: each `run` re-anchors the ramp's window
    (the fix's end points stay), the graph loop captures anew for the
    second window, and its state equals the eager loop's bit for bit."""
    s = card_script(SAMPLE_DECK.format(aeam=AEAM_FILE, t_stop=863.0))
    rows, launches, wall = run_counted(s, SAMPLE_STEPS, modules)
    ref = aeam_engine(dev)
    ref_rows = ref.run(SAMPLE_STEPS, thermo_every=AEAM["check_every"])
    del ref
    if rows != ref_rows:
        raise AssertionError("sample.in through Script differs from phase "
                             "6's Engine")
    check_launches("sample.in deck", launches, ("select_candidates",))
    natoms = s.engine.state.natoms
    # one thermo row on the path it has (AEAM: the strain autograd)
    thermo_ms = wall_ms({"row": lambda: s.engine._thermo(s.engine.state)})
    del s
    ramped = SAMPLE_DECK.format(aeam=AEAM_FILE, t_stop=SAMPLE_RAMP_T)
    g = card_script(ramped)
    e = card_script(ramped + "run 0\n", fused=False)
    keys, ends, windows = [], [], []
    for _ in range(2):
        for sc in (g, e):
            sc.command(f"run {SAMPLE_STEPS}")
        fx = g.fixes[0]
        keys.append(g.engine._loop_key)
        ends.append((fx.t_start, fx.t_stop))
        windows.append((fx.begin_step, fx.end_step))
    check_graph("ramped sample.in deck", g.engine)
    same = same_state(g.engine, e.engine)
    print(f"sample.in through Script: {natoms} atoms, {SAMPLE_STEPS} steps "
          f"equal to phase 6's Engine bit for bit ({wall:.2f} s, launches "
          f"{launches}; a thermo row {thermo_ms['row']:.3f} ms); the "
          f"ramped deck (temp 863 {SAMPLE_RAMP_T}) run "
          f"twice: windows {windows}, end points {ends}, recaptured "
          f"{keys[0] != keys[1]}; graph vs eager bit-identical {same}")
    if ends[0] != ends[1] or ends[0] != (863.0, SAMPLE_RAMP_T):
        raise AssertionError("a run changed the fix's end points")
    if windows != [(0, SAMPLE_STEPS), (SAMPLE_STEPS, 2 * SAMPLE_STEPS)] \
            or keys[0] == keys[1]:
        raise AssertionError("the second run kept the first run's window "
                             "or graph")
    if not all(same.values()):
        raise AssertionError("the ramped sample.in runs: graph loop differs "
                             "from the eager loop")
    out = dict(natoms=natoms, rows_equal_phase6=True,
               ramp_windows=windows, ramp_recaptured=True,
               ramp_graph_equals_eager=True, first_run_s=wall,
               thermo_row_ms=thermo_ms["row"],
               launches_first_run={KERNEL_NAMES["select_candidates"]:
                                   launches["select_candidates"]})
    del g, e
    torch.cuda.empty_cache()
    return out, launches


def script_lj(dev, modules):
    """(c) bench/in.lj from a data file: FIRE on the card (MinResult, ms
    per iteration), then fix langevin + fix nve for 300 steps through the
    graph loop against the eager loop, and the noise of three steps
    against the CPU draw."""
    from lammps_plugins_tpu_torch.api.data import write_data
    from lammps_plugins_tpu_torch.api.scenes import lj_melt
    st = lj_melt(DECKS["lj"], dtype=torch.float64, device="cpu").state
    x = st.x.numpy() + 0.05 * np.random.default_rng(7).standard_normal(
        st.x.shape)
    path = os.path.join(SCRIPT_DIR, "in.lj.jiggled.data")
    write_data(path, st.replace(x=torch.as_tensor(x)))
    deck = LJ_DECK.format(path=path)
    runs = {}
    for name, fused in (("graph", None), ("eager", False)):
        from lammps_plugins_tpu_torch.api.script import Script
        sc = Script(log=lambda _: None)
        sc.run_text(deck)
        sc.engine = sc._make_engine()
        sc.engine._ensure_neighbors()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sc.command(LJ_MINIMIZE)
        torch.cuda.synchronize()
        min_s = time.perf_counter() - t0
        sc.engine.fused_loop = fused
        _, launches, wall = run_counted(sc, LJ_RUN_STEPS, modules)
        runs[name] = (sc, min_s, launches, wall)
    g, e = runs["graph"][0], runs["eager"][0]
    res = g.last_min
    if (res.iterations, res.e_final) != (e.last_min.iterations,
                                         e.last_min.e_final):
        raise AssertionError("FIRE differs between two runs on the card")
    ms_per_it = 1e3 * runs["eager"][1] / max(1, res.iterations)
    same = same_state(g.engine, e.engine)
    fix = g.fixes[0]
    key = fix.key
    noise_same = []
    noise_steps = (0, LJ_RUN_STEPS // 2, LJ_RUN_STEPS)
    for step in noise_steps:
        stc = g.engine.state.replace(extras={key: {"step": torch.tensor(
            step, device=dev)}})
        cpu = stc.replace(x=stc.x.cpu(), v=stc.v.cpu(),
                          extras={key: {"step": torch.tensor(step)}})
        noise_same.append(bool(torch.equal(fix.noise(stc).cpu(),
                                           fix.noise(cpu))))
    launches = runs["graph"][2]
    print(f"in.lj through Script: {g.engine.state.natoms} atoms; "
          f"{res!r}\n  FIRE on the card: {ms_per_it:.3f} ms per iteration "
          f"(eager chunks; the first list built before); then langevin + "
          f"nve {LJ_RUN_STEPS} steps graph vs eager bit-identical {same}, "
          f"launches {launches}; noise on the card = CPU draw at steps "
          f"{noise_steps}: {noise_same}")
    if not all(same.values()) or not all(noise_same):
        raise AssertionError("in.lj: the graph loop differs from the eager "
                             "loop, or the card's noise from the CPU's")
    check_graph("in.lj deck", g.engine)
    check_launches("in.lj deck", launches, LJ_PATH)
    speed = langevin_speed(dev, g.engine, fix)
    # one thermo row on the path it has (lj/cut: the strain autograd)
    thermo_ms = wall_ms({"row": lambda: g.engine._thermo(g.engine.state)})
    print(f"in.lj: a thermo row {thermo_ms['row']:.3f} ms")
    out = dict(natoms=g.engine.state.natoms, thermo_row_ms=thermo_ms["row"],
               min_result=dict(stop=res.stop_criterion,
                               iterations=res.iterations,
                               e_initial=res.e_initial, e_final=res.e_final,
                               fnorm2=res.fnorm2_final),
               fire_ms_per_iteration=ms_per_it,
               fire_wall_s=[runs[n][1] for n in ("graph", "eager")],
               langevin_graph_equals_eager=True, noise_equals_cpu=True,
               run_s=[runs[n][3] for n in ("graph", "eager")], **speed)
    del g, e, runs
    torch.cuda.empty_cache()
    return out, launches


def graph_ms(fn, reps=20):
    """Median device ms of one replay of fn() captured alone in a CUDA
    graph (its launches off the clock, as inside the graph loop)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return timed_ms(graph.replay, reps)


def langevin_speed(dev, eng, fix):
    """The Langevin deck's graph loop (its graph already captured, so no
    capture on the clock) in turns with in.lj's plain NVE graph loop
    (phase 7's Engine, 32,000 atoms at T 1.44): LJ_TIMED_REPS windows of
    LJ_TIMED_STEPS each, atom-steps/s and wall ms per step; and the
    device ms of one noise draw replayed alone in a graph."""
    engines = {"langevin": eng, "nve": deck_engine(dev, "lj")}
    engines["nve"].run(LJ_TIMED_STEPS)             # its capture
    natoms = eng.state.natoms
    out = {name: [] for name in engines}
    for rep in range(LJ_TIMED_REPS):
        names = list(engines) if rep % 2 == 0 else list(engines)[::-1]
        for name in names:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engines[name].run(LJ_TIMED_STEPS)
            torch.cuda.synchronize()
            out[name].append(time.perf_counter() - t0)
    noise_ms = graph_ms(lambda: fix.noise(eng.state))
    ms = {k: [1e3 * t / LJ_TIMED_STEPS for t in v] for k, v in out.items()}
    rate = {k: [natoms * LJ_TIMED_STEPS / t for t in v]
            for k, v in out.items()}
    step_ms = {k: statistics.median(v) for k, v in ms.items()}
    print(f"in.lj graph loop, {LJ_TIMED_REPS} windows of {LJ_TIMED_STEPS} "
          f"steps in turns (capture excluded): langevin + nve atom-steps/s "
          f"{rate['langevin']} (ms/step {ms['langevin']}), plain nve "
          f"{rate['nve']} (ms/step {ms['nve']}); one noise draw [N, 3] "
          f"replayed alone in a graph {noise_ms:.4f} ms, "
          f"{noise_ms / step_ms['langevin']:.3f} of the Langevin step")
    del engines
    return dict(langevin_atom_steps_per_s=rate["langevin"],
                langevin_ms_per_step=ms["langevin"],
                nve_atom_steps_per_s=rate["nve"], nve_ms_per_step=ms["nve"],
                noise_draw_graph_ms=noise_ms,
                timed_steps=LJ_TIMED_STEPS)


def phase9_script(dev, modules):
    """The three decks through the port's Script on the card; returns the
    SCRIPT record and the launch counts of each deck's counted run."""
    import shutil
    free_card("phase 9")
    os.makedirs(SCRIPT_DIR, exist_ok=True)
    try:
        with timed("phase 9 REBOMOS deck"):
            rebomos, l_rebo = script_rebomos(dev, modules)
        with timed("phase 9 sample.in"):
            sample, l_sample = script_sample(dev, modules)
        with timed("phase 9 in.lj"):
            lj, l_lj = script_lj(dev, modules)
    finally:
        shutil.rmtree(SCRIPT_DIR, ignore_errors=True)
    gpu = sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader")
    record = dict(gpu=gpu, rebomos=rebomos, sample=sample, lj=lj)
    launches = {m: l_rebo[m] + l_sample[m] + l_lj[m] for m in l_rebo}
    return record, launches


# -- phase 10: the sharded engine on the card ------------------------------

#: the bench scene's two layouts of four shards: the reference's own 2x2x1
#: processor grid (log.rebomos-bulk.4:22) and four x-slabs
SHARD_LAYOUTS = (("2x2", (2, 2)), ("4 x-slabs", (4, 1)))
SHARD_RUN_STEPS, SHARD_THERMO_EVERY = 300, 100
SHARD_TIMED_STEPS, SHARD_PROFILE_STEPS = 300, 100
#: the sharded engine against the single-device Engine on the same card:
#: step-0 pe (relative) and forces (x scale), the bars of phase 1's full
#: dispatch; then thermo rows at the same step, f32 on both sides with
#: other summation orders: pe and T relative, press over the pressure
#: tensor's largest component
SHARD_PE_BAR, SHARD_F_BAR = 2e-5, 3e-4
#: the static check's scene: the bench scene with every atom moved by up
#: to 0.05 A (on the lattice sites the forces are rounding noise)
SHARD_JIGGLE = 0.05
SHARD_ROW_BARS = dict(pe=2e-5, temp=1e-4, press=1e-3)
#: config 2 in four x-slabs: steps, thermo interval, fix bfield's fsum
#: against the single-device run's (over its largest component)
MELT_SHARD_STEPS, MELT_SHARD_EVERY, FSUM_BAR = 100, 50, 1e-3
#: the melt's rows: its pe (~-4.2 eV an ion) is a sum of Coulomb pair
#: terms of ~1-10 eV of both signs, summed in f32 in another order on
#: each side.  Sound runs read 6.7e-6 (H100, from step 0 on); a sharded
#: graph loop whose in-span re-size was faulty read 4.9e-5, so the bar
#: sits between the two
MELT_ROW_BARS = dict(pe=3e-5, temp=1e-4, press=1e-3)
#: config 5 (benchmarks/scale_multichip.py:45-49): 7,999,488 atoms in eight
#: x-slabs, f32, skin 1.0; pe/atom at step 0 against the bench scene's
SCALE_8M = dict(nx=1302, ny=64, nz=16, shards=8, skin=1.0, steps=100)
PE_ATOM_BAR = 1e-5
SCRIPT_SHARD_STEPS = 200


def shard_engine(dev, state, pair, fixes, grid, fused=None, devices=None,
                 **kw):
    """A ShardedEngine with every shard on `dev` (or on `devices`, one a
    shard; placement= passes through); fused as in aeam_engine."""
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.parallel import ShardedEngine
    se = ShardedEngine(state, pair, fixes, units.METAL,
                       devices=devices or [dev] * (grid[0] * grid[1]),
                       grid=grid, **kw)
    se.fused_loop = fused
    return se


def shard_bench(dev, grid, fused=None, jiggle=0.0, **kw):
    """The bench scene (phase 3's state and pair) in `grid` (grid None:
    phase 3's Engine); jiggle moves every atom by uniform(-jiggle, jiggle)
    A (numpy seed 7), off the lattice sites where the forces are rounding
    noise; kw (devices, placement) to shard_engine."""
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    eng = bench_engine(dev, jiggle=jiggle)
    if grid is None:
        return eng
    return shard_engine(dev, eng.state, eng.pair, [FixNVE()], grid, fused,
                        check_every=BENCH["check_every"], skin=BENCH["skin"],
                        **kw)


def shard_view(se, d=0):
    """Shard d's local block as an Engine-like view (pair bound to its
    charges, its [owned | halo] rows on the slab box, its lists): what
    rebo_at_run_k, mirror_at_run_k and lj_cells_at_run read."""
    import types
    from lammps_plugins_tpu_torch.core.state import State
    blocks = se._halo_blocks(se.shards.x, se.halo)
    x = blocks[d]
    st = State(x=x, v=torch.zeros_like(x), f=torch.zeros_like(x),
               type=se.halo.t_loc[d], q=se.halo.q_loc[d],
               image=torch.zeros(x.shape, dtype=torch.int32,
                                 device=x.device),
               mass=se._mass, box=se.slab_box, step=se.step, extras={})
    return types.SimpleNamespace(pair=se._pair_local(se.halo, d), state=st,
                                 nbr=se.nbrs[d])


def shard_kernels(se, label):
    """A, B, C and D' against their twins on shard 0's own block, lists and
    cells (the pad and halo rows, the slab box non-periodic in x)."""
    view = shard_view(se)
    out = dict(rebo=rebo_at_run_k(view), mirror=mirror_at_run_k(view))
    torch.cuda.empty_cache()
    out["lj_cells"] = lj_cells_at_run(view)
    out["select_candidates"] = candidates_record(
        None, f"{label} shard 0", args=capture_candidate_calls(
            None, lambda: se._resettle(se.shards))[0])
    for r in out.values():
        r["shard"] = 0
    return out


def rows_gap(rows, ref):
    """Largest gaps of thermo rows against reference rows at the same
    steps: pe and temp relative, press over the largest |p_aa|."""
    gap = dict(pe=0.0, temp=0.0, press=0.0)
    for r, s in zip(rows, ref, strict=True):
        if r["step"] != s["step"]:
            raise AssertionError(f"rows at steps {r['step']} / {s['step']}")
        gap["pe"] = max(gap["pe"], abs(r["pe"] - s["pe"]) / abs(s["pe"]))
        gap["temp"] = max(gap["temp"],
                          abs(r["temp"] - s["temp"]) / abs(s["temp"]))
        scale = max(abs(s[k]) for k in ("pxx", "pyy", "pzz"))
        gap["press"] = max(gap["press"], abs(r["press"] - s["press"]) / scale)
    return gap


def shard_state_equal(a, b):
    """{field: bit-identical} of two sharded engines' shard rows, halo
    tables and extras tensors, and their resettle counts."""
    from lammps_plugins_tpu_torch.run.device_loop import extras_items
    same = {f: bool(torch.equal(getattr(a.shards, f), getattr(b.shards, f)))
            for f in ("x", "v", "f", "image", "type", "q", "tag", "valid")}
    same["halo"] = all(torch.equal(getattr(a.halo, f), getattr(b.halo, f))
                       for f in ("t_loc", "q_loc", "valid_loc"))
    ea, eb = (dict(extras_items(e.shards.extras)) for e in (a, b))
    same.update({":".join(p): bool(torch.equal(t, eb[p]))
                 for p, t in ea.items()})
    same["resettles"] = a.resettles == b.resettles
    return same


def shard_of_tag(se):
    """[N] int64: the shard that owns each atom id now."""
    ss = se.shards
    out = torch.full((se.natoms,), -1, dtype=torch.int64,
                     device=ss.x.device)
    d = torch.arange(ss.x.shape[0], device=ss.x.device) // se.n_cap
    out[ss.tag[ss.valid]] = d[ss.valid]
    return out


def resettle_profile(se, top=10):
    """[(device op, ms, calls)] of one resettle of every shard, the `top`
    ops by device time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        se._resettle(se.shards)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    tot = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == cuda:
            t = tot[e.name[:80]]
            t[0] += e.time_range.elapsed_us() / 1e3
            t[1] += 1
    total = sum(ms for ms, _ in tot.values())
    calls = sum(c for _, c in tot.values())
    ops = sorted(tot.items(), key=lambda kv: -kv[1][0])[:top]
    print(f"one resettle: {total:.3f} ms of device time in {calls} device "
          f"ops; the largest: "
          + "; ".join(f"{n} {ms:.3f} ms x{c}" for n, (ms, c) in ops))
    return dict(device_ms=total, device_ops=calls,
                top=[(n, ms, c) for n, (ms, c) in ops])


def windows_in_turns(engines, steps=SHARD_TIMED_STEPS, reps=TIMED_REPS):
    """{name: [atom-steps/s]}: `steps`-step windows of each engine (graph
    loop), in turns, the order reversed every other turn."""
    out = {name: [] for name in engines}
    names = list(engines)
    for rep in range(reps):
        for name in (names if rep % 2 == 0 else names[::-1]):
            eng = engines[name]
            natoms = eng.natoms if hasattr(eng, "natoms") \
                else eng.state.natoms
            sync_all()
            t0 = time.perf_counter()
            eng.run(steps)
            sync_all()
            out[name].append(natoms * steps / (time.perf_counter() - t0))
    return out


def sharded_bench(dev, modules, gpu):
    """(a) the bench scene in both layouts against the single-device Engine
    on the same card.  Returns (records by layout, launches of the 2x2
    graph run by module, shard-0 kernel records of the 2x2 run)."""
    from lammps_plugins_tpu_torch.run.device_loop import device_seconds
    jig = shard_bench(dev, None, jiggle=SHARD_JIGGLE)
    jig._setup_forces()
    st = jig.state
    with torch.no_grad():
        pe1 = float(jig.pair.energy(st.x, None, st.type, jig.nbr, st.box.h))
    f1 = st.f.clone()
    row1 = jig._thermo(st)
    del jig, st
    single = bench_engine(dev)
    natoms = single.state.natoms
    single_rows = single.run(SHARD_RUN_STEPS, thermo_every=SHARD_THERMO_EVERY)
    check_graph("single-device bench", single)
    out, launches0, kernels0 = {}, None, None
    for label, grid in SHARD_LAYOUTS:
        free_card(f"phase 10 (a) {label}")
        torch.cuda.reset_peak_memory_stats()
        se = shard_bench(dev, grid, jiggle=SHARD_JIGGLE)
        se._setup_forces()
        pe2 = se.potential_energy()
        f2 = se.to_state().f
        pe_err = abs(pe2 - pe1) / abs(pe1)
        f_err = float((f2 - f1).abs().max()) / float(f1.abs().max())
        print(f"sharded {label}: caps n_cap {se.n_cap} Bhx {se.Bhx} Bhy "
              f"{se.Bhy} B_mig {se.B_mig} n_loc {se.n_loc}, K "
              f"{dict(se._plan.k_caps)}, cell C {se._plan.cell_capacity}; "
              f"jiggled scene: pe {pe2:.6f} vs single {pe1:.6f} (rel "
              f"{pe_err:.3e}, bar {SHARD_PE_BAR}), forces max|dF|/max|F| "
              f"{f_err:.3e} (bar {SHARD_F_BAR})")
        if not (pe_err <= SHARD_PE_BAR and f_err <= SHARD_F_BAR):
            raise AssertionError(f"sharded {label} pe or forces differ "
                                 "from the single-device Engine's")
        thermo = sharded_thermo_check(se, row1, modules, label)
        kern = shard_kernels(se, label)
        del se
        torch.cuda.empty_cache()
        se = shard_bench(dev, grid)
        se._setup_forces()
        owner0 = shard_of_tag(se)
        for m in modules.values():
            m.launches = 0
        t0 = time.perf_counter()
        rows = se.run(SHARD_RUN_STEPS, thermo_every=SHARD_THERMO_EVERY)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: m.launches for name, m in modules.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if se._loop is None or se._loop.exec is None:
            raise AssertionError(f"sharded {label} did not run through the "
                                 "graph loop")
        check_launches(f"sharded {label}", launches, MAIN_PATH)
        moved = int((shard_of_tag(se) != owner0).sum())
        for r in rows:
            if not all(np.isfinite(v) for v in r.values()):
                raise AssertionError(f"non-finite sharded row {r}")
            print(f"  step {r['step']} T {r['temp']:.6f} pe {r['pe']:.6f} "
                  f"etotal {r['etotal']:.6f} press {r['press']:.4f}")
        drift = (abs(rows[-1]["etotal"] - rows[0]["etotal"])
                 / (rows[-1]["step"] - rows[0]["step"]) / natoms)
        gap = rows_gap(rows, single_rows)
        print(f"sharded {label}: {SHARD_RUN_STEPS} steps in {wall:.2f} s "
              f"(first resettle, capture and thermo rows included), "
              f"launches {launches}, resettles {se.resettles}, regrows "
              f"{se.regrows}, atoms that changed shard {moved}, NVE drift "
              f"{drift:.3e} eV/step/atom (bar 1e-6), rows against the "
              f"single-device run {gap} (bars {SHARD_ROW_BARS}), peak "
              f"{peak:.3f} GiB")
        if not drift < 1e-6:
            raise AssertionError(f"sharded {label} NVE drift above 1e-6")
        if not all(gap[k] <= SHARD_ROW_BARS[k] for k in gap):
            raise AssertionError(f"sharded {label} rows differ from the "
                                 "single-device run's")
        if moved <= 0:
            raise AssertionError(f"sharded {label}: no atom changed shard")
        ref = shard_bench(dev, grid, fused=False)
        ref.run(SHARD_RUN_STEPS, thermo_every=SHARD_THERMO_EVERY)
        same = shard_state_equal(se, ref)
        print(f"sharded {label} graph vs eager host loop after "
              f"{SHARD_RUN_STEPS} steps: bit-identical {same}")
        if not all(same.values()):
            raise AssertionError(f"sharded {label}: the graph loop's state "
                                 "differs from the eager loop's")
        del ref
        torch.cuda.empty_cache()
        rates = windows_in_turns({"sharded": se, "single": single})
        prof = profile_run(se, SHARD_PROFILE_STEPS)
        resettle_ms = 1e3 * device_seconds(
            lambda: se._resettle(se.shards), se.device)
        rs_ops = resettle_profile(se)
        comm_ms = 1e3 * se._comm_cost_estimate()
        med = {k: statistics.median(v) for k, v in rates.items()}
        print(f"sharded {label} on {gpu}: atom-steps/s {rates['sharded']} "
              f"(median {med['sharded']:.6g}) against the single-device "
              f"Engine's {rates['single']} (median {med['single']:.6g}) in "
              f"turns; host launch calls/step "
              f"{prof['host_launch_calls_per_step']:.3f}, device ms/step "
              f"{prof['device_ms_per_step']:.4f}, a resettle {resettle_ms:.3f}"
              f" ms eagerly (device clock, CUDA events), halo refresh "
              f"{comm_ms:.4f} ms a step")
        out[label] = dict(
            grid=list(grid), natoms=natoms, n_cap=se.n_cap, Bhx=se.Bhx,
            Bhy=se.Bhy, B_mig=se.B_mig, n_loc=se.n_loc,
            k_caps=dict(se._plan.k_caps), pe_rel_err=pe_err,
            forces_rel_err=f_err, drift_ev_per_step_atom=drift,
            rows_gap=gap, rows_bars=SHARD_ROW_BARS, atoms_changed_shard=moved,
            resettles=se.resettles, regrows=se.regrows,
            graph_equals_eager=True, atom_steps_per_s=rates["sharded"],
            single_atom_steps_per_s=rates["single"], peak_gib=peak,
            resettle_eager_ms=resettle_ms, resettle_profile=rs_ops,
            halo_refresh_ms=comm_ms, thermo=thermo,
            capture_s=se._loop.capture_s,
            host_launch_calls_per_step=prof["host_launch_calls_per_step"],
            device_ms_per_step=prof["device_ms_per_step"],
            kernels={k: dict(max_abs_err=v["max_abs_err"], ms=v["ms"],
                             plain_ms=v["plain_ms"], bound_ms=v["bound_ms"])
                     for k, v in kern.items()},
            launches={KERNEL_NAMES[m]: launches[m] for m in MAIN_PATH})
        if launches0 is None:
            launches0, kernels0 = launches, kern
        del se
        torch.cuda.empty_cache()
    del single
    return out, launches0, kernels0, single_rows[0]["pe"] / natoms


def sharded_thermo_check(se, ref, modules, label):
    """The sharded thermo row and potential_energy under refuse_plain: A
    and C once a shard each, no twin, no autograd; the row against the
    single Engine's on the same positions (pe 2e-5 relative, pressure
    tensor 5e-4 of its largest component); the row's wall ms."""
    rows = []
    with refuse_plain(), watch_thermo(modules, rows, yardstick=False):
        row = se.thermo()
        pe = se.potential_energy()
    check_thermo_rows(f"sharded {label} thermo", rows)
    if len(rows) != 2 * se.n_devices:
        raise AssertionError(f"sharded {label}: {len(rows)} shard rows")
    keys = ("pxx", "pyy", "pzz", "pxy", "pxz", "pyz")
    scale = max(abs(ref[k]) for k in keys)
    p_err = max(abs(row[k] - ref[k]) for k in keys + ("press",)) / scale
    pe_err = abs(row["pe"] - ref["pe"]) / abs(ref["pe"])
    ms = wall_ms({"row": se.thermo})["row"]
    print(f"sharded {label} thermo row: pe {row['pe']:.6f} vs single "
          f"{ref['pe']:.6f} (rel {pe_err:.3e}, bar {THERMO_PE_BAR}), "
          f"pressure tensor off by {p_err:.3e} of its scale (bar "
          f"{THERMO_W_BAR}); A and C once a shard, no twin, no autograd; "
          f"{ms:.3f} ms a row")
    if not (pe_err <= THERMO_PE_BAR and p_err <= THERMO_W_BAR
            and abs(pe - row["pe"]) <= 1e-6 * abs(pe)):
        raise AssertionError(f"sharded {label} thermo row differs from the "
                             f"single Engine's")
    return dict(pe_rel_err=pe_err, press_err_of_scale=p_err, ms=ms)


def sharded_melt(dev, modules):
    """(b) config 2 in four x-slabs: fsum and thermo rows against the
    single-device run, the graph loop against the eager loop bit for bit
    (fix bfield's extras included)."""
    from lammps_plugins_tpu_torch.api.scenes import charged_melt

    def deck():
        return charged_melt(DECKS["melt"], bz=MELT_BZ, dtype=torch.float32,
                            device=dev)

    free_card("phase 10 (b)")
    single = deck().engine()
    srows = single.run(MELT_SHARD_STEPS, thermo_every=MELT_SHARD_EVERY)
    fsum1 = single.state.extras[single.fixes[0].key]["fsum"].cpu()
    d = deck()
    se = shard_engine(dev, d.state, d.pair, d.fixes, (4, 1), skin=d.skin)
    for m in modules.values():
        m.launches = 0
    rows = se.run(MELT_SHARD_STEPS, thermo_every=MELT_SHARD_EVERY)
    launches = {name: m.launches for name, m in modules.items()}
    if se._loop is None or se._loop.exec is None:
        raise AssertionError("sharded melt did not run through the graph")
    check_launches("sharded melt", launches, LJ_PATH)
    fsum2 = se.fix_view_state().extras[se.fixes[0].key]["fsum"].cpu()
    fsum_err = float((fsum2 - fsum1).abs().max() / fsum1.abs().max())
    gap = rows_gap(rows, srows)
    gap0 = rows_gap(rows[:1], srows[:1])
    d2 = deck()
    ref = shard_engine(dev, d2.state, d2.pair, d2.fixes, (4, 1), fused=False,
                       skin=d2.skin)
    ref.run(MELT_SHARD_STEPS, thermo_every=MELT_SHARD_EVERY)
    same = shard_state_equal(se, ref)
    print(f"sharded melt ({se.natoms} ions, 4 x-slabs): fsum {fsum2.tolist()}"
          f" vs single {fsum1.tolist()} (max gap over max |fsum| "
          f"{fsum_err:.3e}, bar {FSUM_BAR}); rows against the single-device "
          f"run {gap} (bars {MELT_ROW_BARS}; step 0 alone {gap0}); resettles "
          f"{se.resettles} / {ref.resettles}, regrows {se.regrows} / "
          f"{ref.regrows}; graph vs eager bit-identical {same}")
    if not fsum_err <= FSUM_BAR:
        raise AssertionError("sharded melt fsum differs from the single run")
    if not all(gap[k] <= MELT_ROW_BARS[k] for k in gap):
        raise AssertionError("sharded melt rows differ from the single run")
    if not all(same.values()):
        raise AssertionError("sharded melt: graph loop differs from eager")
    return dict(natoms=se.natoms, n_cap=se.n_cap, Bhx=se.Bhx, n_loc=se.n_loc,
                fsum=fsum2.tolist(), fsum_single=fsum1.tolist(),
                fsum_rel_gap=fsum_err, fsum_bar=FSUM_BAR, rows_gap=gap,
                rows_gap_step0=gap0, rows_bars=MELT_ROW_BARS,
                resettles=se.resettles, regrows=se.regrows,
                graph_equals_eager=True,
                launches=launches["select_candidates"])


def scale_engine(dev, nx=SCALE_8M["nx"], **kw):
    """Config 5's ShardedEngine (SCALE_8M; nx may shorten the slabs), kw
    (devices, placement, fused) to shard_engine."""
    from lammps_plugins_tpu_torch.api.scenes import rebomos_bulk_commensurate
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.fixes.velocity import velocity_create
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    c = SCALE_8M
    state = rebomos_bulk_commensurate(nx, c["ny"], c["nz"],
                                      dtype=torch.float32, device=dev)
    state = velocity_create(state, units.METAL, BENCH["temp"], BENCH["seed"])
    pair = REBOMoS.from_file(REBO_FILE, ["M", "S"], dtype=torch.float32,
                             device=dev)
    return shard_engine(dev, state, pair, [FixNVE()], (c["shards"], 1),
                        check_every=BENCH["check_every"], skin=c["skin"],
                        **kw)


def sharded_scale(dev, modules, gpu, pe_atom_bench):
    """(c) config 5: 7,999,488 atoms in eight x-slabs on the one card."""
    c = SCALE_8M
    free_card("phase 10 (c)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    se = scale_engine(dev)
    natoms = se.natoms
    setup_s = time.perf_counter() - t0
    pe_atom = se.potential_energy() / natoms
    pe_err = abs(pe_atom - pe_atom_bench) / abs(pe_atom_bench)
    print(f"config 5: {natoms} atoms in {c['shards']} x-slabs (scene and "
          f"engine {setup_s:.1f} s), n_cap {se.n_cap} Bhx {se.Bhx} n_loc "
          f"{se.n_loc}, K {dict(se._plan.k_caps)}, ghosts per shard "
          f"{[n.ghosts.count for n in se.nbrs]}; pe/atom at step 0 "
          f"{pe_atom:.7f} vs the bench scene's {pe_atom_bench:.7f} (rel "
          f"{pe_err:.3e}, bar {PE_ATOM_BAR})")
    if not pe_err <= PE_ATOM_BAR:
        raise AssertionError("config 5 pe/atom differs from the bench's")
    for m in modules.values():
        m.launches = 0
    t0 = time.perf_counter()
    rows = se.run(c["steps"], thermo_every=c["steps"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: m.launches for name, m in modules.items()}
    if se._loop is None or se._loop.exec is None:
        raise AssertionError("config 5 did not run through the graph loop")
    check_launches("config 5", launches, MAIN_PATH)
    for r in rows:
        if not all(np.isfinite(v) for v in r.values()):
            raise AssertionError(f"non-finite config 5 row {r}")
    drift = (abs(rows[-1]["etotal"] - rows[0]["etotal"])
             / (rows[-1]["step"] - rows[0]["step"]) / natoms)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    se.run(c["steps"])
    torch.cuda.synchronize()
    rate = natoms * c["steps"] / (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2 ** 30
    thermo_ms = wall_ms({"row": se.thermo})["row"]
    thermo_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = dict(natoms=natoms, shards=c["shards"], skin=c["skin"],
               n_cap=se.n_cap, Bhx=se.Bhx, n_loc=se.n_loc,
               B_mig=se.B_mig, k_caps=dict(se._plan.k_caps),
               ghosts=[n.ghosts.count for n in se.nbrs],
               halo_rows=[int(v.sum()) - int(o.sum()) for v, o in zip(
                   se.halo.valid_loc, se.shards.valid.view(c["shards"], -1))],
               pe_atom=pe_atom, pe_atom_bench=pe_atom_bench,
               pe_atom_rel_err=pe_err, drift_ev_per_step_atom=drift,
               rows=[{k: r[k] for k in ("step", "temp", "pe", "etotal",
                                        "press")} for r in rows],
               first_run_s=wall, atom_steps_per_s=rate, peak_gib=peak,
               thermo_row_ms=thermo_ms, thermo_row_peak_gib=thermo_peak,
               allocated_before_thermo_gib=base,
               resettles=se.resettles, regrows=se.regrows,
               capture_s=se._loop.capture_s, gpu=gpu,
               launches={KERNEL_NAMES[m]: launches[m] for m in MAIN_PATH})
    print(f"config 5: {c['steps']} steps (first run {wall:.1f} s with the "
          f"first resettle, capture and two thermo rows), NVE drift "
          f"{drift:.3e} eV/step/atom (bar 1e-6), {rate:.6g} atom-steps/s "
          f"(a second {c['steps']}-step window) on {gpu}, peak {peak:.3f} "
          f"GiB, resettles {se.resettles}, launches {launches}; a thermo "
          f"row {thermo_ms:.3f} ms, peak {thermo_peak:.3f} GiB over it "
          f"({base:.3f} allocated before)")
    if not drift < 1e-6:
        raise AssertionError("config 5 NVE drift above 1e-6 eV/step/atom")
    del se
    torch.cuda.empty_cache()
    return out


def sharded_script(dev):
    """(d) the phase-9 REBOMOS deck (no outputs) through
    Script(n_devices=4, devices=[card] * 4) for SCRIPT_SHARD_STEPS, its
    thermo rows against the single-device Script's."""
    from lammps_plugins_tpu_torch.api.script import Script
    from lammps_plugins_tpu_torch.parallel import ShardedEngine
    free_card("phase 10 (d)")
    text = REBO_DECK.format(rebo=REBO_FILE, outputs="")
    run = f"run {SCRIPT_SHARD_STEPS}\n"
    s1 = card_script(text + run)
    rows1 = s1.last_rows
    natoms = s1.engine.state.natoms
    del s1
    torch.cuda.empty_cache()
    s4 = Script(log=lambda _: None, n_devices=4, devices=[dev] * 4)
    t0 = time.perf_counter()
    s4.run_text(text + run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng = s4.engine
    if not isinstance(eng, ShardedEngine):
        raise AssertionError("Script(n_devices=4) did not build a "
                             "ShardedEngine")
    if eng._loop is None or eng._loop.exec is None:
        raise AssertionError("the sharded Script did not run through the "
                             "graph loop")
    gap = rows_gap(s4.last_rows, rows1)
    print(f"sharded Script ({natoms} atoms, {SCRIPT_SHARD_STEPS} steps in "
          f"{wall:.2f} s): rows against the single-device Script {gap} "
          f"(bars {SHARD_ROW_BARS}), resettles {eng.resettles}")
    if not all(gap[k] <= SHARD_ROW_BARS[k] for k in gap):
        raise AssertionError("the sharded Script's rows differ")
    return dict(natoms=natoms, steps=SCRIPT_SHARD_STEPS, rows_gap=gap,
                rows=[{k: r[k] for k in ("step", "temp", "pe", "press")}
                      for r in s4.last_rows], wall_s=wall)


def entry_checks():
    """(e) the port's entry checks called with their defaults, so on the
    card in float32: entry()'s force pass on the 288-atom scene and
    dryrun_multichip(4) (a resettle, a segment, a second resettle)."""
    from lammps_plugins_tpu_torch.entry import dryrun_multichip, entry
    fn, args = entry()
    if not args[0].is_cuda:
        raise AssertionError("entry() did not run on the card")
    e, f, w = fn(*args)
    if not (bool(torch.isfinite(f).all()) and bool(torch.isfinite(w).all())
            and f.shape == (288, 3)):
        raise AssertionError("entry(): non-finite or misshapen output")
    t0 = time.perf_counter()
    dryrun_multichip(4)
    torch.cuda.synchronize()
    out = dict(entry_pe=float(e), entry_max_f=float(f.abs().max()),
               dryrun_s=time.perf_counter() - t0)
    print(f"entry checks on the card: {out}")
    return out


# -- phase 10 (f): the per-device placement ---------------------------------

#: the [card, cpu] check: the 864-atom scene of tests/test_torch_sharded_rebo
#: (four x-slabs there; two here, one a device) in f32, at step 0 against
#: the stacked layout on the card (SHARD_PE_BAR, SHARD_F_BAR), then a few
#: eager steps across the two devices, finite
MIXED = dict(nx=12, ny=8, nz=1, temp=600.0, seed=3, skin=0.5, steps=20)


def sync_all():
    """Wait for every card (the per-device placement's streams)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def reset_peaks():
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)


def peaks_gib():
    """Each card's peak allocated GiB since reset_peaks()."""
    return [torch.cuda.max_memory_allocated(i) / 2 ** 30
            for i in range(torch.cuda.device_count())]


def per_device_launches(se, label):
    """[{kernel: launches}] of each shard since reset_shard_launches; every
    CUDA shard must have launched A, B, C and D' itself."""
    out = []
    for d, (dev, c) in enumerate(zip(se.group.devices, se.shard_launches())):
        missing = [m for m in MAIN_PATH if c[m] <= 0]
        if dev.type == "cuda" and missing:
            raise AssertionError(f"{label}: shard {d} on {dev} launched no "
                                 f"{missing}")
        out.append({KERNEL_NAMES[m]: c[m] for m in MAIN_PATH})
    return out


def card_devices(n):
    """n shard devices over min(device count, 4) distinct cards (one
    stream a shard)."""
    k = min(torch.cuda.device_count(), 4)
    return [torch.device("cuda", i % k) for i in range(n)]


def per_device_bench(dev, modules, gpu, devices_of):
    """The bench scene per device in both layouts (devices_of(n): the
    shards' devices): per-device graph = per-device eager = stacked on
    `dev` bit for bit after SHARD_RUN_STEPS steps with resettles; A, B, C
    and D' launched on every shard; atom-steps/s in turns with the stacked
    layout; host launch calls a step; peak GiB."""
    out = {}
    for label, grid in SHARD_LAYOUTS:
        n = grid[0] * grid[1]
        devices = devices_of(n)
        free_card(f"phase 10 (f) {label}")
        stacked = shard_bench(dev, grid)
        srows = stacked.run(SHARD_RUN_STEPS, thermo_every=SHARD_THERMO_EVERY)
        sync_all()
        reset_peaks()
        se = shard_bench(dev, grid, devices=devices, placement="per_device")
        se._setup_forces()
        owner0 = shard_of_tag(se)
        for m in modules.values():
            m.launches = 0
        se.reset_shard_launches()
        t0 = time.perf_counter()
        rows = se.run(SHARD_RUN_STEPS, thermo_every=SHARD_THERMO_EVERY)
        sync_all()
        wall = time.perf_counter() - t0
        launches = {name: m.launches for name, m in modules.items()}
        per_shard = per_device_launches(se, f"per-device {label}")
        peak = peaks_gib()
        if se._prog is None:
            raise AssertionError(f"per-device {label} did not run through "
                                 "its captured program")
        check_launches(f"per-device {label}", launches, MAIN_PATH)
        moved = int((shard_of_tag(se) != owner0).sum())
        eager = shard_bench(dev, grid, fused=False, devices=devices,
                            placement="per_device")
        erows = eager.run(SHARD_RUN_STEPS, thermo_every=SHARD_THERMO_EVERY)
        same_eager = shard_state_equal(se, eager)
        same_stacked = shard_state_equal(se, stacked)
        rows_equal = rows == srows and erows == srows
        print(f"per-device {label} on {[str(d) for d in devices]}: "
              f"{SHARD_RUN_STEPS} steps in {wall:.2f} s (the first resettle, "
              f"the warm-up, the capture and thermo rows included), "
              f"resettles {se.resettles}, regrows {se.regrows}, atoms that "
              f"changed shard {moved}, launches {launches}, per shard "
              f"{per_shard}; graph vs eager bit-identical {same_eager}; "
              f"vs stacked {same_stacked}; thermo rows equal {rows_equal}; "
              f"peak GiB by card {peak} (the stacked engine's included); "
              f"a segment replays "
              f"{se._prog.graph_launches()} graph launches and "
              f"{len(se._prog.collectives)} collectives")
        if not (all(same_eager.values()) and all(same_stacked.values())
                and rows_equal):
            raise AssertionError(f"per-device {label}: the graph run, the "
                                 "eager run and the stacked run differ")
        if moved <= 0:
            raise AssertionError(f"per-device {label}: no atom changed shard")
        del eager
        free_card(f"phase 10 (f) {label} timing")
        rates = windows_in_turns({"per_device": se, "stacked": stacked})
        prof = profile_run(se, SHARD_PROFILE_STEPS)
        sprof = profile_run(stacked, SHARD_PROFILE_STEPS)
        med = {k: statistics.median(v) for k, v in rates.items()}
        print(f"per-device {label} on {gpu}: atom-steps/s "
              f"{rates['per_device']} (median {med['per_device']:.6g}) "
              f"against the stacked layout's {rates['stacked']} (median "
              f"{med['stacked']:.6g}) in turns; host launch calls a step "
              f"{prof['host_launch_calls_per_step']:.3f} (stacked "
              f"{sprof['host_launch_calls_per_step']:.3f}), graph launches "
              f"a step {prof['graph_launches_per_step']:.3f}, device ms a "
              f"step {prof['device_ms_per_step']:.4f} (stacked "
              f"{sprof['device_ms_per_step']:.4f}), host syncs per 1,000 "
              f"steps {prof['syncs_per_1000_steps']:.1f}")
        out[label] = dict(
            grid=list(grid), devices=[str(d) for d in devices],
            natoms=se.natoms, resettles=se.resettles, regrows=se.regrows,
            atoms_changed_shard=moved, graph_equals_eager=True,
            equals_stacked=True, launches={KERNEL_NAMES[m]: launches[m]
                                           for m in MAIN_PATH},
            launches_per_shard=per_shard, peak_gib_by_card=peak,
            first_run_s=wall,
            atom_steps_per_s=rates["per_device"],
            stacked_atom_steps_per_s=rates["stacked"],
            host_launch_calls_per_step=prof["host_launch_calls_per_step"],
            stacked_host_launch_calls_per_step=sprof[
                "host_launch_calls_per_step"],
            graph_launches_per_step=prof["graph_launches_per_step"],
            device_ms_per_step=prof["device_ms_per_step"],
            stacked_device_ms_per_step=sprof["device_ms_per_step"],
            syncs_per_1000_steps=prof["syncs_per_1000_steps"],
            segment_graph_launches=se._prog.graph_launches(),
            segment_collectives=len(se._prog.collectives))
        se.close()
        del se, stacked
        free_card(f"phase 10 (f) {label} done")
    return out


def per_device_melt(dev, modules):
    """Config 2 in four x-slabs per device on the card against the stacked
    layout: the trajectory bit for bit, fix bfield's fsum (a psum, in
    another order) within FSUM_BAR, thermo rows within MELT_ROW_BARS,
    graph = eager bit for bit, D' launched on every shard."""
    from lammps_plugins_tpu_torch.api.scenes import charged_melt

    def engine(**kw):
        d = charged_melt(DECKS["melt"], bz=MELT_BZ, dtype=torch.float32,
                         device=dev)
        return shard_engine(dev, d.state, d.pair, d.fixes, (4, 1),
                            skin=d.skin, **kw)

    free_card("phase 10 (f) config 2")
    stacked = engine()
    srows = stacked.run(MELT_SHARD_STEPS, thermo_every=MELT_SHARD_EVERY)
    se = engine(placement="per_device")
    for m in modules.values():
        m.launches = 0
    se.reset_shard_launches()
    rows = se.run(MELT_SHARD_STEPS, thermo_every=MELT_SHARD_EVERY)
    launches = {name: m.launches for name, m in modules.items()}
    if se._prog is None:
        raise AssertionError("per-device melt did not run its program")
    check_launches("per-device melt", launches, LJ_PATH)
    per_shard = [c["select_candidates"] for c in se.shard_launches()]
    if min(per_shard) <= 0:
        raise AssertionError(f"per-device melt: D' per shard {per_shard}")
    key = se.fixes[0].key
    fsum = se.fix_view_state().extras[key]["fsum"].cpu()
    fsum_s = stacked.fix_view_state().extras[key]["fsum"].cpu()
    fsum_err = float((fsum - fsum_s).abs().max() / fsum_s.abs().max())
    gap = rows_gap(rows, srows)
    eager = engine(placement="per_device", fused=False)
    eager.run(MELT_SHARD_STEPS, thermo_every=MELT_SHARD_EVERY)
    same_eager = shard_state_equal(se, eager)
    same_stacked = {k: v for k, v in shard_state_equal(se, stacked).items()
                    if not k.endswith(":fsum")}
    print(f"per-device melt ({se.natoms} ions, 4 x-slabs): fsum "
          f"{fsum.tolist()} vs stacked {fsum_s.tolist()} (max gap over max "
          f"|fsum| {fsum_err:.3e}, bar {FSUM_BAR}); rows against the stacked "
          f"run {gap} (bars {MELT_ROW_BARS}); graph vs eager bit-identical "
          f"{same_eager}; vs stacked (fsum aside) {same_stacked}; D' per "
          f"shard {per_shard}")
    if not (fsum_err <= FSUM_BAR
            and all(gap[k] <= MELT_ROW_BARS[k] for k in gap)
            and all(same_eager.values()) and all(same_stacked.values())):
        raise AssertionError("per-device melt differs from the stacked run "
                             "or from its eager run")
    se.close()
    return dict(natoms=se.natoms, fsum=fsum.tolist(),
                fsum_stacked=fsum_s.tolist(), fsum_rel_gap=fsum_err,
                rows_gap=gap, graph_equals_eager=True,
                trajectory_equals_stacked=True,
                select_candidates_per_shard=per_shard)


def per_device_scale(dev, modules, gpu, pe_atom_bench, stacked):
    """Config 5 per device, eight x-slabs on the card: 100 steps through
    the captured programs, pe/atom at step 0 against the bench scene's,
    NVE drift, atom-steps/s of a second window (after (c)'s stacked run
    in this call, not in turns: both do not fit at once) and the peak
    beside (c)'s.  A config that does not fit the card is reported with
    the memory it reached, and the next smaller one (three quarters of
    the slabs' length) is run."""
    c = dict(SCALE_8M)
    refused = []
    while True:
        free_card(f"phase 10 (f) config 5 nx={c['nx']}")
        reset_peaks()
        se = None
        try:
            se = scale_engine(dev, c["nx"], devices=card_devices(c["shards"]),
                              placement="per_device")
            natoms = se.natoms
            for m in modules.values():
                m.launches = 0
            se.reset_shard_launches()       # the first resettle counts
            pe_atom = se.potential_energy() / natoms
            t0 = time.perf_counter()
            rows = se.run(c["steps"], thermo_every=c["steps"])
            sync_all()
            wall = time.perf_counter() - t0
            launches = {name: m.launches for name, m in modules.items()}
            per_shard = per_device_launches(se, "per-device config 5")
            t0 = time.perf_counter()
            se.run(c["steps"])
            sync_all()
            rate = natoms * c["steps"] / (time.perf_counter() - t0)
            peak = max(peaks_gib())
            break
        except torch.cuda.OutOfMemoryError as e:
            peak = max(peaks_gib())
            refused.append(dict(nx=c["nx"], peak_gib_reached=peak,
                                error=str(e).splitlines()[0][:200]))
            print(f"per-device config 5 at nx={c['nx']} does not fit the "
                  f"card: {peak:.3f} GiB allocated at the failure "
                  f"({refused[-1]['error']})")
            if se is not None:
                se.close()
            del se
            if len(refused) >= 3:
                raise
            c["nx"] = int(c["nx"] * 0.75) // 2 * 2
    if se._prog is None:
        raise AssertionError("per-device config 5 did not run its program")
    check_launches("per-device config 5", launches, MAIN_PATH)
    pe_err = abs(pe_atom - pe_atom_bench) / abs(pe_atom_bench)
    drift = (abs(rows[-1]["etotal"] - rows[0]["etotal"])
             / (rows[-1]["step"] - rows[0]["step"]) / natoms)
    out = dict(natoms=natoms, nx=c["nx"], shards=c["shards"],
               devices=[str(d) for d in se.group.devices],
               refused=refused, pe_atom=pe_atom, pe_atom_rel_err=pe_err,
               drift_ev_per_step_atom=drift, first_run_s=wall,
               atom_steps_per_s=rate, peak_gib=peak,
               peak_gib_by_card=peaks_gib(),
               stacked_atom_steps_per_s=stacked["atom_steps_per_s"],
               stacked_peak_gib=stacked["peak_gib"],
               resettles=se.resettles, launches_per_shard=per_shard,
               launches={KERNEL_NAMES[m]: launches[m] for m in MAIN_PATH},
               gpu=gpu)
    print(f"per-device config 5: {natoms} atoms in {c['shards']} x-slabs on "
          f"{out['devices']}, pe/atom {pe_atom:.7f} (rel {pe_err:.3e} to the "
          f"bench's, bar {PE_ATOM_BAR}), NVE drift {drift:.3e} (bar 1e-6), "
          f"{rate:.6g} atom-steps/s (the stacked layout's "
          f"{stacked['atom_steps_per_s']:.6g} earlier in this call) on "
          f"{gpu}, peak {peak:.3f} GiB (stacked {stacked['peak_gib']:.3f}); "
          f"resettles {se.resettles}")
    if not (pe_err <= PE_ATOM_BAR and drift < 1e-6):
        raise AssertionError("per-device config 5: pe/atom or drift off")
    se.close()
    del se
    free_card("phase 10 (f) config 5 done")
    return out


def mixed_devices(dev):
    """The [card, cpu] check: two x-slabs, shard 0 on the card, shard 1 on
    the CPU (its kernels' twins, as every CPU tensor takes), every
    cross-shard move a copy between the two; eager.  pe and forces at
    step 0 against the stacked layout on the card (SHARD_PE_BAR,
    SHARD_F_BAR), then MIXED["steps"] steps, finite and without a lost
    atom."""
    from lammps_plugins_tpu_torch.api.scenes import rebomos_bulk
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.fixes.velocity import velocity_create
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    c = MIXED

    def engine(devices):
        st = velocity_create(rebomos_bulk(c["nx"], c["ny"], c["nz"],
                                          tilt_xy=0.0, dtype=torch.float32,
                                          device=dev),
                             units.METAL, c["temp"], c["seed"])
        pair = REBOMoS.from_file(REBO_FILE, ["M", "S"], dtype=torch.float32,
                                 device=dev)
        return shard_engine(dev, st, pair, [FixNVE()], (2, 1),
                            devices=devices, skin=c["skin"])

    ref = engine([dev, dev])
    mixed = engine([dev, torch.device("cpu")])
    pe_r, pe_m = ref.potential_energy(), mixed.potential_energy()
    ref._setup_forces()
    mixed._setup_forces()
    f_r = ref.to_state().f
    f_m = mixed.to_state().f.to(dev)
    pe_err = abs(pe_m - pe_r) / abs(pe_r)
    f_err = float((f_m - f_r).abs().max()) / float(f_r.abs().max())
    mixed.run(c["steps"])
    end = mixed.to_state()
    ok = bool(torch.isfinite(end.x).all() and torch.isfinite(end.v).all())
    print(f"[card, cpu] two x-slabs ({mixed.natoms} atoms, f32): pe "
          f"{pe_m:.6f} vs stacked on the card {pe_r:.6f} (rel {pe_err:.3e}, "
          f"bar {SHARD_PE_BAR}), forces max|dF|/max|F| {f_err:.3e} (bar "
          f"{SHARD_F_BAR}); {c['steps']} eager steps, {mixed.resettles} "
          f"resettles, finite {ok}")
    if not (pe_err <= SHARD_PE_BAR and f_err <= SHARD_F_BAR and ok):
        raise AssertionError("[card, cpu] differs from the stacked layout")
    return dict(natoms=mixed.natoms, devices=[str(dev), "cpu"],
                pe_rel_err=pe_err, forces_rel_err=f_err,
                steps=c["steps"], resettles=mixed.resettles)


#: can one shard's capture wait on an event recorded inside another's (one
#: CUDA graph per shard and segment, joined by events)?  Run in a child
#: process: a capture that CUDA refuses leaves PyTorch's allocator routing
#: to a graph pool that never closes, and the parent's memory could not be
#: freed any more
CAPTURE_PROBE = """
import json, torch
s0, s1 = torch.cuda.Stream(), torch.cuda.Stream()
g0, g1 = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
x = torch.zeros(4, device="cuda")
ev = torch.cuda.Event()
torch.cuda.synchronize()
out = {}
with torch.cuda.stream(s0):
    g0.capture_begin(capture_error_mode="thread_local")
    x.add_(1)
    ev.record(s0)
with torch.cuda.stream(s1):
    g1.capture_begin(capture_error_mode="thread_local")
    try:
        s1.wait_event(ev)
        out["wait"] = "accepted"
    except Exception as e:
        out["wait"] = str(e).splitlines()[0]
print(json.dumps(out))
"""


def capture_probe():
    """The design question of the per-device placement's graphs, asked of
    the card in a child process: the answer decides between one graph per
    shard and segment and one per shard and piece between collectives."""
    r = subprocess.run([sys.executable, "-c", CAPTURE_PROBE],
                       capture_output=True, text=True, timeout=120)
    lines = r.stdout.strip().splitlines()
    answer = json.loads(lines[-1]) if r.returncode == 0 and lines else dict(
        error=(r.stderr.strip().splitlines() or ["no output"])[-1])
    print(f"capture probe: shard 1's capture waiting on an event of shard "
          f"0's capture -> {answer}")
    return answer


def per_device_checks(dev, modules, gpu, pe_atom, scale):
    """(f) the per-device placement: the bench scene's two layouts and
    config 2 on the one card (a stream a shard), config 5, the [card, cpu]
    check; on several cards the bench scene again over min(count, 4)."""
    out = dict(capture_probe=capture_probe())
    # config 5 first, on the emptiest card: eight streams on one card each
    # cache their own freed memory
    with timed("phase 10 (f) config 5 per device"):
        out["scale"] = per_device_scale(dev, modules, gpu, pe_atom, scale)
    with timed("phase 10 (f) bench scene per device"):
        out["bench"] = per_device_bench(dev, modules, gpu,
                                        lambda n: [dev] * n)
    with timed("phase 10 (f) config 2 per device"):
        out["melt"] = per_device_melt(dev, modules)
    with timed("phase 10 (f) [card, cpu]"):
        out["card_cpu"] = mixed_devices(dev)
    n = torch.cuda.device_count()
    if n >= 2:
        with timed("phase 10 (f) several cards"):
            out["cards"] = per_device_bench(dev, modules, gpu, card_devices)
    else:
        print(f"phase 10 (f) on several cards did not run: this machine has "
              f"{n} CUDA device")
        out["cards"] = None
    return out


def phase10_sharded(dev, modules):
    """The sharded engine on the card: (a) the bench scene, (b) config 2,
    (c) config 5, (d) the sharded Script, (e) the entry checks, (f) the
    per-device placement.  Returns (record, launches of the bench's 2x2
    graph run, shard-0 kernel records)."""
    gpu = sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader")
    with timed("phase 10 (a) bench scene"):
        bench, launches, kern, pe_atom = sharded_bench(dev, modules, gpu)
    with timed("phase 10 (b) config 2"):
        melt = sharded_melt(dev, modules)
    with timed("phase 10 (c) config 5"):
        scale = sharded_scale(dev, modules, gpu, pe_atom)
    with timed("phase 10 (d) sharded Script"):
        script = sharded_script(dev)
    with timed("phase 10 (e) entry checks"):
        entry = entry_checks()
    per_device = per_device_checks(dev, modules, gpu, pe_atom, scale)
    out = dict(gpu=gpu, bench=bench, melt=melt, scale=scale, script=script,
               entry=entry, per_device=per_device)
    print("SHARDED " + json.dumps(out))
    return out, launches, kern


# -- phase 11: lists past the card's former size limits ---------------------

#: the wide-cut charged melt: config 2's deck (phase 7) with
#: lj/cut/coul/cut 6 12 and LAMMPS's default metal skin, 2 A, so that K
#: passes 256 (bcc 4.2 A: 330 sites within 14 A)
WIDE = dict(cut_lj=6.0, cut_coul=12.0, skin=2.0, steps=300, thermo=100,
            profile_steps=50)
#: the REBOMOS bench scene at skin 4.0: the REBO list's K past 64
SKIN4 = dict(skin=4.0, steps=100)
#: kernel A against its twin on the run's planes, this many atoms at a
#: time (the twin's autograd keeps [atoms, K, K] angular terms)
REBO_TWIN_ATOMS = 16384
#: D on seeded rows: K and W, N rows of six kinds each (select_k_rows)
WIDE_SELECT_K = dict(ks=(320, 512, 1024), ws=(2048, 4096), rows=1998)
#: D' on an lj/cut deck of ~1,400 neighbours a row, and on NTYPES types
LJ_WIDE = dict(n=12, cut=7.0, skin=0.3)
NTYPES = 21


def wide_melt(n, dtype=torch.float32, device=None):
    """charged_melt(n)'s deck with lj/cut/coul/cut 6 12 and skin 2."""
    from lammps_plugins_tpu_torch.api.scenes import charged_melt
    from lammps_plugins_tpu_torch.potentials.ljcut import PairLJCutCoulCut
    deck = charged_melt(n, bz=MELT_BZ, dtype=dtype, device=device)
    pair = PairLJCutCoulCut(WIDE["cut_lj"], WIDE["cut_coul"], ntypes=2,
                            qqr2e=deck.units.qqr2e, dtype=dtype,
                            device=device)
    pair.set_coeff(1, 1, 0.01, 2.5)
    pair.set_coeff(2, 2, 0.01, 3.4)
    return dataclasses.replace(deck, pair=pair, skin=WIDE["skin"])


def wide_run(eng):
    """eng.run(WIDE steps) with thermo rows every WIDE["thermo"] steps;
    returns (rows, [(step, K)])."""
    rows, ks = [], []

    def note(row):
        rows.append(row)
        ks.append((row["step"], dict(eng._plan.k_caps)["main"]))

    eng.run(WIDE["steps"], thermo_every=WIDE["thermo"], on_thermo=note)
    return rows, ks


def wide_melt_path(dev, modules, gpu):
    """The 65,536-ion wide-cut melt through the graph loop with the
    counters reset: K past 256, D' and kernel I launched (no other
    kernel), finite thermo, the state equal to an eager Engine's bit for
    bit; both loops' windows in turns; D' on a rebuild of the run exact
    against its twin."""
    eng = wide_melt(DECKS["melt"], device=dev).engine()
    natoms = eng.state.natoms
    torch.cuda.reset_peak_memory_stats()
    for m in modules.values():
        m.launches = 0
    t0 = time.perf_counter()
    rows, ks = wide_run(eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {m: mod.launches for m, mod in modules.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"wide melt (graph loop): {natoms} ions, {WIDE['steps']} steps in "
          f"{wall:.2f} s, K by thermo row {ks}, launches {launches}, "
          f"rebuilds {eng.rebuilds}, peak {peak:.3f} GiB")
    if eng._loop is None or eng._loop.exec is None:
        raise AssertionError("the wide melt did not run through the graph")
    check_launches("wide melt", launches, LJ_PATH)
    if not min(k for _, k in ks) > 256:
        raise AssertionError(f"the wide melt's K stayed within 256: {ks}")
    for r in rows:
        if not all(np.isfinite(v) for v in r.values()):
            raise AssertionError(f"non-finite wide melt thermo row {r}")
    if not torch.isfinite(eng.state.x).all() \
            or not torch.isfinite(eng.state.f).all():
        raise AssertionError("non-finite wide melt positions or forces")
    ref = wide_melt(DECKS["melt"], device=dev).engine()
    ref.fused_loop = False
    wide_run(ref)
    same = same_state(eng, ref)
    print(f"wide melt graph vs eager loop: bit-identical {same}")
    if not all(same.values()):
        raise AssertionError("the wide melt's graph loop differs from the "
                             "eager loop")
    numbers = loop_numbers({"graph": eng, "eager": ref}, gpu,
                           steps=WIDE["steps"],
                           profile_steps=WIDE["profile_steps"],
                           kernels=("select_candidates_kernel",))
    del ref
    torch.cuda.empty_cache()
    out = dict(natoms=natoms, k_by_row=ks, rebuilds_main_run=eng.rebuilds,
               launches=launches["select_candidates"], peak_gib=peak,
               thermo=[{k: r[k] for k in ("step", "temp", "pe", "etotal")}
                       for r in rows], graph_equals_eager=True, **numbers)
    out["select_candidates"] = candidates_record(eng, "wide melt")
    return out


def rebo_vs_twin_in_chunks(eng):
    """Kernel A on the run's own planes against its twin, the twin taken
    REBO_TWIN_ATOMS atoms at a time (each output column depends on its
    own column's inputs only); bar 5e-4 x scale.  plain_ms: the chunks'
    twin times summed."""
    from lammps_plugins_tpu_torch.ops import rebo
    pair, st, nbr = eng.pair, eng.state, eng.nbr
    planes = pair._rebo_planes(st.x, pair.el_of_type[st.type], nbr.ghosts,
                               nbr.lists["rebo"], st.box.h)
    cst = pair._rebo_consts
    K, Np = planes[0].shape
    gk = rebo.rebo_cotangents(*planes, cst)
    err, scale, plain = 0.0, 0.0, 0.0
    for c0 in range(0, Np, REBO_TWIN_ATOMS):
        part = [p[:, c0:c0 + REBO_TWIN_ATOMS].contiguous()
                for p in planes[:5]] + [planes[5][c0:c0 + REBO_TWIN_ATOMS]]
        gt = rebo.rebo_cotangents_ref(*part, cst)
        scale = max(scale, max(float(t.abs().max()) for t in gt))
        err = max(err, max(float((a[:, c0:c0 + REBO_TWIN_ATOMS] - b)
                                 .abs().max()) for a, b in zip(gk, gt)))
        plain += device_ms(lambda: rebo.rebo_cotangents_ref(*part, cst))
        del gt, part
    work = rebo_work(planes, cst)
    b_ms, b_by = bound(*work[:3])
    out = dict(K=K, Np=Np, atoms_a_block=rebo.rebo_plan(K)[0],
               max_abs_err=err, bar=5e-4 * scale,
               ms=timed_ms(lambda: rebo.rebo_cotangents(*planes, cst), 20),
               plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
               live_edges_hist=work[3], library_ms=None)
    print(f"rebo_cotangents at K={K} on the run's planes: max_abs_err "
          f"{err:.3e} (bar {out['bar']:.3e}), kernel {out['ms']:.4f} ms, "
          f"twin {plain:.4f} ms in chunks, bound {b_ms:.4f} ms by {b_by}; "
          f"live edges per atom "
          f"{ {n: c for n, c in enumerate(work[3]) if c} }")
    if not err <= out["bar"]:
        raise AssertionError(f"rebo_cotangents disagrees with its twin at "
                             f"K={K}")
    return out


def skin4_path(dev, modules):
    """The bench scene at skin 4.0 through the graph loop with the counters
    reset: the REBO K past 64, A, B, C and D' launched, the NVE drift, the
    state equal to an eager Engine's bit for bit, A on the run's planes
    against its twin, D' on a rebuild of the run."""
    eng = bench_engine(dev, skin=SKIN4["skin"])
    for m in modules.values():
        m.launches = 0
    t0 = time.perf_counter()
    rows = eng.run(SKIN4["steps"], thermo_every=SKIN4["steps"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {m: mod.launches for m, mod in modules.items()}
    K = dict(eng._plan.k_caps)["rebo"]
    print(f"skin 4.0 (graph loop): {eng.state.natoms} atoms, "
          f"{SKIN4['steps']} steps in {wall:.2f} s (sizing and capture "
          f"included), K {dict(eng._plan.k_caps)}, LJ cell capacity "
          f"{eng._plan.cell_capacity}, launches {launches}, rebuilds "
          f"{eng.rebuilds}")
    if eng._loop is None or eng._loop.exec is None:
        raise AssertionError("the skin-4.0 run did not use the graph loop")
    check_launches("skin 4.0", launches, MAIN_PATH)
    if not K > 64:
        raise AssertionError(f"the skin-4.0 REBO list has K = {K}")
    drift = check_run(eng, rows)
    ref = bench_engine(dev, skin=SKIN4["skin"])
    ref.fused_loop = False
    ref.run(SKIN4["steps"], thermo_every=SKIN4["steps"])
    same = same_state(eng, ref)
    print(f"skin 4.0 graph vs eager loop: bit-identical {same}")
    if not all(same.values()):
        raise AssertionError("the skin-4.0 graph loop differs from the "
                             "eager loop")
    del ref
    torch.cuda.empty_cache()
    out = dict(K=K, k_caps=dict(eng._plan.k_caps),
               cell_capacity=eng._plan.cell_capacity,
               drift_ev_per_step_atom=drift, rebuilds=eng.rebuilds,
               wall_s_first_run=wall, graph_equals_eager=True,
               launches={KERNEL_NAMES[m]: launches[m] for m in MAIN_PATH},
               rebo_cotangents=rebo_vs_twin_in_chunks(eng))
    out["select_candidates"] = candidates_record(eng, "skin 4.0")
    return out


def select_k_rows(dev, N, K, W):
    """[N, W] keys (two payloads) whose rows cycle through six kinds: no
    hit, K / 2, K, and 3K (past the hit buffer) hits of quantized keys
    (ties), then K + 17 and 3K hits all tied; columns at random."""
    g = torch.Generator(device=dev).manual_seed(K + W)
    kinds = torch.arange(N, device=dev) % 6
    counts = torch.tensor([0, K // 2, K, min(W, 3 * K), K + 17,
                           min(W, 3 * K)], device=dev)[kinds]
    u = torch.rand((N, W), generator=g, device=dev)
    thr = torch.sort(u, dim=1).values.gather(
        1, (counts - 1).clamp(min=0)[:, None])
    hit = (u <= thr) & (counts > 0)[:, None]
    vals = torch.round(torch.rand((N, W), generator=g, device=dev)
                       * 64.0) / 16.0
    vals = torch.where((kinds >= 4)[:, None], torch.full_like(vals, 1.5),
                       vals)
    keys = torch.where(hit, vals, torch.full_like(vals, float("inf")))
    ids = torch.randint(0, 2 ** 24, (N, W), generator=g, device=dev).float()
    typ = torch.randint(1, 3, (N, W), generator=g, device=dev).float()
    return keys, ids, typ


def select_k_wide(dev):
    """D exact against its twin at each K and W of WIDE_SELECT_K on
    select_k_rows, reruns identical; its time beside torch.topk's (the
    yardstick, another tie order) and its bound."""
    from lammps_plugins_tpu_torch.ops import select_k
    out = {}
    N = WIDE_SELECT_K["rows"]
    for K in WIDE_SELECT_K["ks"]:
        for W in WIDE_SELECT_K["ws"]:
            keys, ids, typ = select_k_rows(dev, N, K, W)
            sk = select_k.select_k(keys, K, payloads=(ids, typ))
            st = select_k.select_k_ref(keys, K, payloads=(ids, typ))
            again = select_k.select_k(keys, K, payloads=(ids, typ))
            if not all(torch.equal(a, b) and torch.equal(a, c)
                       for a, b, c in zip(sk, st, again)):
                raise AssertionError(f"select_k differs from its twin at "
                                     f"K={K} W={W}")
            t = interleaved_ms({
                "kernel": lambda: select_k.select_k(keys, K, (ids, typ)),
                "topk": lambda: torch.topk(keys, K, dim=1, largest=False,
                                           sorted=True)}, 10)
            b_ms, b_by = bound(4 * N * W + 20 * N * K, N * W)
            out[f"K{K}_W{W}"] = dict(
                exact=True, ms=t["kernel"], library_ms=t["topk"],
                plain_ms=timed_ms(lambda: select_k.select_k_ref(
                    keys, K, (ids, typ)), 3),
                bound_ms=b_ms, bound_by=b_by,
                max_hits=int((keys < float("inf")).sum(dim=1).max()))
            print(f"select_k K={K} W={W} ({N} rows of 0, K/2, K, 3K, K + 17 "
                  f"tied and 3K tied hits): exact, kernel "
                  f"{t['kernel']:.4f} ms, topk {t['topk']:.4f} ms, bound "
                  f"{b_ms:.4f} ms")
            del keys, ids, typ, sk, st, again
    return out


def lj_wide_engine(dev):
    """lj_melt(12) (6,912 atoms) with lj/cut 7.0 and skin 0.3: ~1,400
    neighbours a row and ~500-slot fine cells."""
    from lammps_plugins_tpu_torch.api.scenes import lj_melt
    from lammps_plugins_tpu_torch.potentials.ljcut import PairLJCut
    deck = lj_melt(LJ_WIDE["n"], device=dev)
    pair = PairLJCut(LJ_WIDE["cut"], ntypes=1, device=dev)
    pair.set_coeff(1, 1, 1.0, 1.0)
    return dataclasses.replace(deck, pair=pair,
                               skin=LJ_WIDE["skin"]).engine()


def mixture_engine(dev, ntypes, n=10, seed=21):
    """A jiggled fcc lj/cut mixture of 4 n^3 atoms at the LJ melt's
    density, ntypes types at random, every type pair with its own eps,
    sigma and cut in [2.0, 3.0] (numpy seed), skin 0.3."""
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.core.box import Box
    from lammps_plugins_tpu_torch.core.state import State
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.potentials.ljcut import PairLJCut
    from lammps_plugins_tpu_torch.run.simulation import Engine
    rng = np.random.default_rng(seed)
    a = (4.0 / 0.8442) ** (1.0 / 3.0)
    base = a * np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                         [0, 0.5, 0.5]])
    cells = a * np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"),
                         -1).reshape(-1, 3)
    x = (cells[:, None, :] + base[None]).reshape(-1, 3)
    x = x + rng.uniform(-0.08, 0.08, x.shape)
    types = rng.integers(1, ntypes + 1, len(x))
    pair = PairLJCut(3.0, ntypes=ntypes, device=dev)
    for i in range(1, ntypes + 1):
        for j in range(i, ntypes + 1):
            pair.set_coeff(i, j, rng.uniform(0.5, 1.5), rng.uniform(0.8, 1.2),
                           rng.uniform(2.0, 3.0))
    st = State.create(x=x, type=types,
                      box=Box.orthogonal([n * a] * 3, device=dev),
                      mass=np.ones(ntypes + 1))
    return Engine(st, pair, [FixNVE()], units.LJ, skin=0.3)


def wide_kernel_checks(dev):
    """D' on lj_melt(12) with lj/cut 7.0 (K past 1,024, its cells too
    large to stage, read in place) and on the NTYPES-type mixture; D on
    select_k_rows at the WIDE_SELECT_K shapes; each exact against its
    twin."""
    from lammps_plugins_tpu_torch.ops.select_candidates import (
        candidates_plan)
    out = {}
    for label, eng in (("lj_cut_7", lj_wide_engine(dev)),
                       (f"types_{NTYPES}", mixture_engine(dev, NTYPES))):
        args = capture_candidate_calls(eng)[-1]
        K, Cf, nt = args[5], args[1].shape[1], args[4].shape[0]
        p = candidates_plan(K, Cf, nt)
        rec = candidates_record(eng, label, args=args)
        rec.update(types=nt - 1, warps=p.warps, hit_buffer=p.cap,
                   bucket_sort=p.bucket, brick_cells=p.bx,
                   staged=p.staged, shared_bytes=p.nbytes)
        print(f"{label}: K={K} Cf={Cf} types {nt - 1}: {p.warps} warps a "
              f"block, hit buffer {p.cap}, bucket sort {p.bucket}, bricks "
              f"of {p.bx} cells, staged {p.staged}, {p.nbytes} bytes of "
              f"shared memory")
        out[label] = rec
        del eng, args
        torch.cuda.empty_cache()
    if not (out["lj_cut_7"]["K"] > 1024
            and not out["lj_cut_7"]["staged"]
            and out[f"types_{NTYPES}"]["types"] >= 20):
        raise AssertionError(f"the kernel checks missed their shapes: {out}")
    out["select_k"] = select_k_wide(dev)
    return out


def phase11_wide(dev, modules):
    """Lists past the card's former limits (`WIDE {json}`): the wide-cut
    melt and the skin-4.0 REBOMOS scene through the graph loop, f32
    forces of the wide-cut deck, and the kernel-only checks."""
    gpu = sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader")
    free_card("phase 11")
    with timed("phase 11 wide-cut melt"):
        melt = wide_melt_path(dev, modules, gpu)
    free_card("phase 11 f32 forces")
    with timed("phase 11 f32 forces"):
        accuracy = ljcut_f32_accuracy(dev, (("wide_melt", wide_melt, 8,
                                             0.1),))
    free_card("phase 11 skin 4.0")
    with timed("phase 11 skin 4.0"):
        skin4 = skin4_path(dev, modules)
    free_card("phase 11 kernels")
    with timed("phase 11 kernels"):
        kernels = wide_kernel_checks(dev)
    out = dict(gpu=gpu, melt=melt, f32_force_err_over_rms=accuracy,
               skin4=skin4, kernels=kernels)
    print("WIDE " + json.dumps(out))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--golden-rebo", default="",
                    help="path of the published MoS.REBO.set5b")
    ap.add_argument("--prev-tree", default="",
                    help="tree of an earlier lammps_plugins_tpu_torch/ whose "
                         "LJ sweeps, select-k and reaction combine are "
                         "timed in turns with this one's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda:0")
    modules = ops_modules()
    from lammps_plugins_tpu_torch.ops import build
    PREV["this"] = build
    if args.prev_tree:
        PREV.update(build=load_build("prev", args.prev_tree),
                    tree=args.prev_tree)
    with timed("phase 0"):
        phase0_environment()
    with timed("phase 1"):
        results = phase1_kernels(dev, args.prev_tree)
    with timed("phase 2"):
        phase2_f32_accuracy(dev)
    with timed("phase 3"):
        launches, at_run_k = phase3_main_path(dev, modules)
    results["rebo_cotangents"]["at_run_k"] = at_run_k
    phase5_golden(dev, args.golden_rebo)
    with timed("phase 6"):
        results["select_candidates"]["aeam"] = phase6_aeam(dev, modules)
    with timed("phase 7"):
        d_records, results["ljcut_forces"] = phase7_bfield(dev, modules)
        results["select_candidates"].update(d_records)
    with timed("phase 8"):
        mono_launches, mono = phase8_monolayer(dev, modules)
    with timed("phase 9"):
        script, script_launches = phase9_script(dev, modules)
    for m in MAIN_PATH:
        results[KERNEL_NAMES[m]]["script"] = dict(
            launches=script_launches[m])
    # this slice's path: one thermo row and one stress/atom, counted alone
    for m in ("rebo", "mirror", "lj_cells"):
        results[KERNEL_NAMES[m]]["thermo_path"] = dict(
            launches=script["rebomos"]["thermo_path"]["launches"][m])
    print("SCRIPT " + json.dumps(script))
    with timed("phase 10"):
        sharded, shard_launches, shard_kern = phase10_sharded(dev, modules)
    pd = sharded["per_device"]["bench"]["2x2"]
    for m in MAIN_PATH:
        name = KERNEL_NAMES[m]
        results[name]["sharded"] = dict(
            shard_kern[m], launches=shard_launches[m])
        # the per-device placement's 2x2 run: every shard launched it
        results[name]["per_device"] = dict(
            launches=pd["launches"][name],
            launches_per_shard=[c[name] for c in pd["launches_per_shard"]])
    with timed("phase 11"):
        wide = phase11_wide(dev, modules)
    results["select_candidates"]["wide"] = dict(
        wide["melt"]["select_candidates"],
        launches=wide["melt"]["launches"],
        skin4=dict(wide["skin4"]["select_candidates"],
                   launches=wide["skin4"]["launches"]["select_candidates"]),
        **{k: v for k, v in wide["kernels"].items() if k != "select_k"})
    results["rebo_cotangents"]["skin4"] = dict(
        wide["skin4"]["rebo_cotangents"],
        launches=wide["skin4"]["launches"]["rebo_cotangents"])
    results["select_k"]["wide"] = wide["kernels"]["select_k"]
    # phase 4 runs last: after a profiled run (phase 3), its four Engines'
    # graphs leave torch.profiler recording no D' kernel inside the later
    # graph loops' windows (phase 6 on, in this order; the graph runs it:
    # graph = eager holds through those windows), in this tree and in the
    # parent's; no later phase profiles
    with timed("phase 4"):
        by_config = phase4_configurations(dev, modules)
    for m in MAIN_PATH:
        results[KERNEL_NAMES[m]]["monolayer"] = dict(
            {"rebo": mono["rebo_at_run_k"], "mirror": mono["mirror_at_run_k"],
             "lj_cells": mono["lj_cells_at_run"],
             "select_candidates": mono["select_candidates"]}[m],
            launches=mono_launches[m])
    # each kernel's count from the runs of the paths that use it: the main
    # path's for its kernels, else the configurations' (the AEAM, deck and
    # monolayer paths' counts stand in each kernel's record of that path)
    runs = [(MAIN_PATH, launches)] + [(used, by_config[name])
                                      for name, _, _, used in CONFIGS]
    kernels = []
    for m, name in KERNEL_NAMES.items():
        paths = [c for used, c in runs if m in used]
        if m in MAIN_PATH:
            paths = paths[:1]
        # kernel I runs on no REBOMOS path: its count is the LJ decks'
        count = (results[name]["launches"] if m == "ljcut"
                 else sum(c[m] for c in paths))
        kernels.append(dict(results[name], launches=count))
    print(json.dumps({"kernels": kernels}))
    print(sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
