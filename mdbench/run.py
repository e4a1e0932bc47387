#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once and print its result line.

    python3 mdbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control 1]

Run from the root of a checkout on a machine with the cards the cell asks
for.  The last line of standard output is one JSON object (correct,
attempted, failed, metrics, device, with --trace 1 breakdown, and last
the numbers compared with their limits); the numbers compared are also
the last lines of standard error.  --trace 0 reports the cell's
end-to-end metrics, --trace 1 its per-layer metrics from a profiled
window.  --control 1 puts the plain reference computed in bfloat16 in the
program's place for the compared steps and outputs (the control of the
comparison; the benchmark's own runs never pass it).  Exits non-zero and prints no
result without enough CUDA devices, or when jax, jaxlib, flax or the JAX
package is loaded in the process.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """perf_counter() at the moment this process started."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.perf_counter() - (uptime - ticks / os.sysconf(
            "SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_PROC = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import torch  # noqa: E402

import harness as H  # noqa: E402
import devtrace as T  # noqa: E402


def run_cell(c: dict, bench: dict, seed: int, seconds: float, traced: bool,
             device, control: bool = False, t_proc: float | None = None,
             log=print) -> dict:
    """One run of the cell `c` (harness.cell): the result line's dict."""
    cfg, trf, root = c["cfg"], c["trf"], c["root"]
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_proc = T_PROC if t_proc is None else t_proc
    k = trf["check_steps"]
    phases = dict(imports=H.now() - t_proc)
    t = H.now()
    inp = H.inputs(cfg, seed, device, root)
    start_in = H.start_state(cfg, inp, root)
    phases["inputs"] = H.now() - t
    t = H.now()
    driver = H.find("drivers", trf["driver"], root)
    drv = driver.Driver(c, inp, device, log)
    natoms = drv.natoms
    phases["build"] = H.now() - t
    # set-up: the compared first steps, then the warm-up and the sizing
    t = H.now()
    got_start = drv.start(k)
    phases["start_check"] = H.now() - t
    t = H.now()
    n_window = drv.prepare(seconds)
    sync()
    phases["warmup_and_sizing"] = H.now() - t
    mark = drv.counters()
    # the window
    prof = T.profiler() if traced else None
    if prof is not None:
        prof.__enter__()
    t0 = H.now()
    setup_s = t0 - t_proc
    drv.window(n_window)
    sync()
    t1 = H.now()
    if prof is not None:
        prof.__exit__(None, None, None)
    after = drv.counters()
    steps = after["step"] - mark["step"]
    window_s = t1 - t0
    timers = {s: v - mark["timers"].get(s, 0.0)
              for s, v in after["timers"].items()}
    forbidden = H.loaded_forbidden()
    peak = max((torch.cuda.max_memory_allocated(d)
                for d in range(c["chips"])), default=0) if cuda else 0
    # the compared end steps, through the same call
    end_in, got_end = drv.end(k)
    rebuilds_at_check = got_end["rebuilds"] - end_in["rebuilds"]
    spans = drv.spans() if traced and cuda else {}
    outs = drv.outputs()
    drv.close()
    drv = None
    H.free_program()
    # the reference, once the program's state is freed, over the cell's
    # cards
    cards = [torch.device(device)]
    if cuda:
        cards = [torch.device("cuda", i) for i in range(c["chips"])]
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
    t = H.now()
    pot = H.reference_potential(cfg, cards, root)
    if control:
        got_start = H.control_state(cfg, inp, pot, start_in, k, root)
        got_end = H.control_state(cfg, inp, pot, end_in, k, root)
    nums = H.worst(H.compare(cfg, inp, pot, start_in, got_start, k, root),
                   H.compare(cfg, inp, pot, end_in, got_end, k, root))
    if hasattr(driver, "compare_outputs"):
        nums.update(driver.compare_outputs(
            c, inp, pot, outs, dict(start=start_in, end=end_in), control))
    sync()
    log(f"# reference: {H.now() - t:.3f} s on {len(cards)} card(s), peak "
        "GiB " + json.dumps([torch.cuda.max_memory_allocated(d) / 2 ** 30
                             for d in cards] if cuda else []))
    log("# numbers " + json.dumps(nums))
    checks = {name: dict(value=nums.get(name, math.nan), limit=limit)
              for name, limit in trf["limits"].items()}
    failed = [n for n, v in checks.items()
              if not (math.isfinite(v["value"]) and v["value"] <= v["limit"])]
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=c["chips"], memory_peak_bytes=int(peak),
               power_limit=H.power_limit() if cuda else "none")
    out = dict(correct=not failed and not forbidden, attempted=len(checks),
               failed=len(failed))
    log(f"# cell {c['name']} seed {seed}: {natoms} atoms, {steps} steps in "
        f"{window_s:.6f} s ({after['rebuilds'] - mark['rebuilds']} "
        f"rebuilds), rebuilds at the end check {rebuilds_at_check}, "
        f"recaptured in the "
        f"window: {after['loop'] != mark['loop']}, {dev['power_limit']}")
    log("# setup phases (s) " + json.dumps(phases))
    if traced:
        summary = T.summarize(prof)
        x_end = got_end["x"]
        pairs = pot.pairs(x_end, inp["h"], inp["types"])
        rec = dict(cell=c["name"], cfg=cfg, steps=steps, natoms=natoms,
                   window_s=window_s, trace=summary, spans=spans,
                   timers=timers,
                   counts=pot.counts(x_end, inp["h"], inp["types"], pairs))
        metrics = {}
        for m in H.per_layer(bench, c["name"]):
            v = H.reader(m["name"], root)(rec)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
        cards = list(summary["cards"].values())
        dev["busy_s"] = (sum(cd["busy_s"] for cd in cards) / len(cards)
                         if cards else 0.0)
        dev["window_s"] = window_s
        out["metrics"] = metrics
        out["device"] = dev
        out["breakdown"] = dict(device_ops=T.top_ops(summary),
                                idle_gaps=[[n, s] for n, s in
                                           summary["idle_gaps"]])
        log("# records " + json.dumps(dict(
            launch_calls=summary["launch_calls"], spans=spans,
            counts=rec["counts"], timers=timers,
            cards={d: dict(busy_s=cd["busy_s"], memcpy=cd["memcpy"])
                   for d, cd in summary["cards"].items()})))
    else:
        vals = dict(atom_steps_per_s=natoms * steps / window_s,
                    peak_gib=peak / 2 ** 30, setup_s=setup_s)
        out["metrics"] = {m["name"]: dict(value=vals[H.quantity(m["name"])],
                                          unit=m["unit"])
                          for m in H.end_to_end(bench, c["name"])}
        out["device"] = dev
    if forbidden:
        out["forbidden_modules"] = forbidden
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    bench = H.bench_file()
    c = H.cell(bench, a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < c["chips"]:
        print(f"mdbench: cell {a.workload} needs {c['chips']} CUDA "
              f"device(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(c, bench, a.seed, a.seconds, bool(a.trace), "cuda",
                   control=bool(a.control),
                   log=lambda s: print(s, file=sys.stderr))
    forbidden = H.loaded_forbidden()
    for name, v in out["checks"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    if forbidden or "forbidden_modules" in out:
        print("mdbench: forbidden modules loaded: "
              f"{forbidden or out['forbidden_modules']}", file=sys.stderr)
        return 3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
