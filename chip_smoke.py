#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (lammps_plugins_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--golden-rebo PATH_TO_MoS.REBO.set5b]

Phases (any failure raises, so the script exits non-zero):
  0. toolchain report; TF32 off; nvcc build of csrc/*.cu for sm_90a
  1. each CUDA kernel against its plain-PyTorch twin at the bench scene's
     shapes (97,920 atoms, REBO K and the cell/candidate widths from the
     rebuild plan): max error against the JAX suite's bars, median times
  2. f32 forces of the 288-atom scene on the card (device rebuild +
     kernels) against the float64 CPU twin forces: max|dF| < 1e-2 RMS(F)
  3. the main path: Engine.run on the 97,920-atom scene (f32, skin 0.8,
     check every 10 steps, 300 K from seed 12345) with every launch
     counter reset first; asserts that each kernel launched, that the
     thermo is finite and the NVE drift < 1e-6 eV/step/atom; then three
     timed 1,000-step runs for atom-steps/s (median and range)
  4. golden thermo rows of in.rebomos-bulk, only when --golden-rebo names
     the published MoS.REBO.set5b (not in the repository)

The parameters are the synthetic file tests/data/MoS.REBO.synthetic.
Output ends with a JSON line of per-kernel results, the card's name and
power limit (nvidia-smi), and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
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
BENCH = dict(nx=34, ny=48, nz=10, skin=0.8, check_every=10, temp=300.0,
             seed=12345)
RUN_STEPS = 300        # at 300 K the list is rebuilt about every 43 steps
TIMED_STEPS = 1000     # a timed window spans ~20 rebuilds
TIMED_REPS = 3
GOLDEN = [(0, 0.0, -2061.6112), (10, 80.776057, -2064.6132),
          (20, 146.17503, -2067.0428)]     # log.rebomos-bulk.1:54-56


def sh(*cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True,
                          timeout=120).stdout.strip()


def timed_ms(fn, reps=10, warmup=2) -> float:
    """Median device time of fn() in ms (CUDA events, synchronised)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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


def bench_engine(dev):
    """The bench scene on the card with its velocities; no lists yet."""
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.api.scenes import rebomos_bulk_commensurate
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.fixes.velocity import velocity_create
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    from lammps_plugins_tpu_torch.run.simulation import Engine
    state = rebomos_bulk_commensurate(BENCH["nx"], BENCH["ny"], BENCH["nz"],
                                      dtype=torch.float32, device=dev)
    state = velocity_create(state, units.METAL, BENCH["temp"], BENCH["seed"])
    pair = REBOMoS.from_file(REBO_FILE, ["M", "S"], dtype=torch.float32,
                             device=dev)
    return Engine(state, pair, [FixNVE()], units.METAL,
                  check_every=BENCH["check_every"], skin=BENCH["skin"])


def phase1_kernels(dev):
    """Each kernel vs its twin on the bench scene's own tensors."""
    from lammps_plugins_tpu_torch.ops import lj_cells, mirror, rebo, select_k
    eng = bench_engine(dev)
    eng.rebuild_neighbors()
    pair, st, nbr = eng.pair, eng.state, eng.nbr
    rl = nbr.lists["rebo"]
    K, Np = rl.idxT.shape
    Wp = -(-27 * eng._plan.cand_capacity // 128) * 128
    print(f"bench shapes: N={st.natoms} K={K} Np={Np} W={Wp} "
          f"C={nbr.cells.table.shape[1]} cell dims={nbr.cells.dims} "
          f"a_range={nbr.cells.a_range}")
    results = {}

    def record(name, err, bar, k_ms, t_ms, source, replaces):
        print(f"{name}: max_abs_err={err:.3e} (bar {bar:.3e}) "
              f"kernel {k_ms:.4f} ms, twin {t_ms:.4f} ms")
        if not err <= bar:
            raise AssertionError(f"{name} disagrees with its twin: "
                                 f"{err} > {bar}")
        results[name] = dict(name=name, route="cuda", source=source,
                             replaces=replaces, max_abs_err=err, ms=k_ms,
                             plain_ms=t_ms)

    # A: REBO cotangents, bar 5e-4 * scale
    planes = pair._rebo_planes(st.x, pair.el_of_type[st.type], nbr.ghosts,
                               rl, st.box.h)
    cst = pair._rebo_consts
    gk = rebo.rebo_cotangents(*planes, cst)
    gt = rebo.rebo_cotangents_ref(*planes, cst)
    scale = max(float(t.abs().max()) for t in gt)
    err = max(float((a - b).abs().max()) for a, b in zip(gk, gt))
    record("rebo_cotangents", err, 5e-4 * scale,
           timed_ms(lambda: rebo.rebo_cotangents(*planes, cst)),
           timed_ms(lambda: rebo.rebo_cotangents_ref(*planes, cst), reps=3),
           "lammps_plugins_tpu_torch/csrc/rebo.cu",
           "lammps_plugins_tpu/ops/rebo_pallas.py:233")

    # B: mirror combine, bar 1e-5 * scale (f32 sums in another order)
    mv = rl.mirvT.float()
    fk = mirror.mirror_combine(*gk, rl.mirT, mv)
    ft = mirror.mirror_combine_ref(*gk, rl.mirT, mv)
    err = float((fk - ft).abs().max())
    record("mirror_combine", err, 1e-5 * float(ft.abs().max()),
           timed_ms(lambda: mirror.mirror_combine(*gk, rl.mirT, mv)),
           timed_ms(lambda: mirror.mirror_combine_ref(*gk, rl.mirT, mv)),
           "lammps_plugins_tpu_torch/csrc/mirror.cu",
           "lammps_plugins_tpu/ops/mirror_pallas.py:75")

    # C: LJ cell sweep, forces 2e-4 * scale, energy 2e-5 relative
    P = pair._cell_planes(st.x, nbr.ghosts, nbr.cells, st.box.h)
    ar, lc = nbr.cells.a_range, pair._lj_consts
    ok = lj_cells.lj_cell_forces(P, lc, ar, with_energy=True)
    ot = lj_cells.lj_cell_forces_ref(P, lc, ar, with_energy=True)
    errf = float((ok[..., :3, :] - ot[..., :3, :]).abs().max())
    ek, et = float(ok[..., 3, :].double().sum()), \
        float(ot[..., 3, :].double().sum())
    print(f"lj energy: kernel {ek:.8e} twin {et:.8e} "
          f"rel {abs(ek - et) / abs(et):.3e} (bar 2e-5)")
    if not abs(ek - et) <= 2e-5 * abs(et):
        raise AssertionError("lj_cell_forces energy row disagrees")
    record("lj_cell_forces", errf,
           2e-4 * float(ot[..., :3, :].abs().max()),
           timed_ms(lambda: lj_cells.lj_cell_forces(P, lc, ar)),
           timed_ms(lambda: lj_cells.lj_cell_forces_ref(P, lc, ar), reps=3),
           "lammps_plugins_tpu_torch/csrc/lj_cells.cu",
           "lammps_plugins_tpu/ops/lj_cells_pallas.py:389")

    # D: select_k on [N, W] candidate-like keys (seeded; quantized so that
    # ties occur; most slots invalid as in a cell window), exact
    g = torch.Generator(device=dev).manual_seed(BENCH["seed"])
    N = st.natoms
    keys = torch.round(torch.rand((N, Wp), generator=g, device=dev)
                       * 21.0 * 64.0) / 64.0
    keys = torch.where(torch.rand((N, Wp), generator=g, device=dev) < 0.05,
                       keys, torch.full_like(keys, float("inf")))
    ids = torch.randint(0, 2 ** 24, (N, Wp), generator=g, device=dev).float()
    typ = torch.randint(1, 3, (N, Wp), generator=g, device=dev).float()
    sk = select_k.select_k(keys, K, payloads=(ids, typ))
    stw = select_k.select_k_ref(keys, K, payloads=(ids, typ))
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(sk, stw))
    record("select_k", err, 0.0,
           timed_ms(lambda: select_k.select_k(keys, K, (ids, typ))),
           timed_ms(lambda: select_k.select_k_ref(keys, K, (ids, typ))),
           "lammps_plugins_tpu_torch/csrc/select_k.cu",
           "lammps_plugins_tpu/ops/select_k_pallas.py:69")
    del eng, planes, gk, gt, P, ok, ot, keys, ids, typ
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


def phase3_main_path(dev, modules):
    """Engine.run on the bench scene; every kernel must launch in it."""
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
    print(f"main run: {RUN_STEPS} steps in {wall:.2f} s (first rebuild, "
          f"plan sizing and two thermo rows included), launches {launches}")
    for r in rows:
        print(f"  step {r['step']} T {r['temp']:.6f} pe {r['pe']:.6f} "
              f"etotal {r['etotal']:.6f} press {r['press']:.4f}")
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    for r in rows:
        if not all(np.isfinite(v) for v in r.values()):
            raise AssertionError(f"non-finite thermo row {r}")
    if not torch.isfinite(eng.state.x).all() \
            or not torch.isfinite(eng.state.f).all():
        raise AssertionError("non-finite positions or forces")
    drift = abs(rows[-1]["etotal"] - rows[0]["etotal"]) / (RUN_STEPS * natoms)
    print(f"NVE drift {drift:.3e} eV/step/atom (bar 1e-6)")
    if not drift < 1e-6:
        raise AssertionError("NVE energy drift above 1e-6 eV/step/atom")

    rates, rebuilds = [], []
    for _ in range(TIMED_REPS):
        rb0 = eng.rebuilds
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(TIMED_STEPS)
        torch.cuda.synchronize()
        rates.append(natoms * TIMED_STEPS / (time.perf_counter() - t0))
        rebuilds.append(eng.rebuilds - rb0)
    gpu = sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader")
    print(f"steady runs: {TIMED_REPS} x {TIMED_STEPS} steps, atom-steps/s "
          f"{', '.join(f'{r:.6g}' for r in rates)} (median "
          f"{statistics.median(rates):.6g}, min {min(rates):.6g}, max "
          f"{max(rates):.6g}; {natoms} atoms, f32) on {gpu}; rebuilds "
          f"{rebuilds} in the timed runs; K={dict(eng._plan.k_caps)}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return launches


def phase4_golden(dev, path):
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--golden-rebo", default="",
                    help="path of the published MoS.REBO.set5b")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    from lammps_plugins_tpu_torch.ops import lj_cells, mirror, rebo, select_k
    dev = torch.device("cuda:0")
    modules = {"rebo_cotangents": rebo, "mirror_combine": mirror,
               "lj_cell_forces": lj_cells, "select_k": select_k}
    phase0_environment()
    results = phase1_kernels(dev)
    phase2_f32_accuracy(dev)
    launches = phase3_main_path(dev, modules)
    phase4_golden(dev, args.golden_rebo)
    kernels = [dict(results[n], launches=launches[n]) for n in modules]
    print(json.dumps({"kernels": kernels}))
    print(sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
