"""The parts of one run that every cell shares: the benchmark's data found
by name, the inputs made from the seed, and the comparison with the
plain reference that decides `correct`.

Everything that belongs to one configuration, traffic, per-layer metric
or kind of thing a configuration names is a file found by name:

  BENCHMARK.json          the cells, each naming its configuration and
                          its traffic
  configs/<name>.json     a configuration: scene, pair style, fixes, sizes
  workloads/<name>.json   a traffic: its driver, steps, outputs, limits
  scenes/<kind>.py        make(device, **params) -> (x, types, h)
  styles/<style>.py       a pair style: program(), reference(), deck()
  fixes/<style>.py        a fix: program(), reference(), start(),
                          snapshot(), deck()
  drivers/<name>.py       how the program is driven: Driver, and
                          optionally compare_outputs()
  metrics/<name>.py       a per-layer metric: read(rec) -> float | None

A style's name reads '/' as '_' in its file name (lj/cut: lj_cut.py).  A
metric named <quantity>.<part> is a quantity split by cells, where cells
need their own bound or move their own end-to-end metric: it reads as
<quantity> (its reader is metrics/<quantity>.py).

The comparison follows the program step by step from its own state, since
an MD trajectory cannot be followed in another precision for thousands
of steps.  Twice a run, the program runs `check_steps` steps through the
same call as the window: from the seed's inputs as the first steps of its
set-up (the start), and from its state where the window closed (the
end).  The reference, in float64, follows the same steps from the same
starting state with its own neighbour search, potential and integrator,
and the numbers compared are

  f_rms   rms over atoms of |F_program - F_reference| / rms |F_reference|
  f_max   max over atoms of |F_program - F_reference| / rms |F_reference|,
          both at the program's positions after the steps
  x_max   max over atoms of |x_program - x_reference| after the steps
          (length units, unwrapped)
  v_rms   rms |v_program - v_reference| / rms |v_reference| after them
  f_window  (configurations whose lists are exact at every step) the
          forces the window's last step left, against the reference's at
          the same positions, as f_max

each the larger of the start and the end reading; a driver whose window
writes outputs adds its own numbers (compare_outputs).  In control mode
the reference in bfloat16 stands in the program's place.  The reference
keeps its pair lists and sums by blocks spread over the cell's cards
(reference/neighbors.py), so that its memory follows the blocks and not
the number of pairs.
"""

from __future__ import annotations

import functools
import gc
import importlib.util
import json
import math
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (os.path.join(HERE, "reference"), HERE):
    if p not in sys.path:
        sys.path.insert(0, p)
if ROOT not in sys.path:
    sys.path.append(ROOT)

from integrate import UNITS, Integrator, MDState, rms  # noqa: E402

#: modules whose presence in the process fails a run (whole top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "lammps_plugins_tpu")
#: CUDA event spans timed after the window (median of these many)
SPAN_REPS = 5


# -- the benchmark's data ------------------------------------------------------
def load_json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def bench_file(root=ROOT) -> dict:
    return load_json(root, "BENCHMARK.json")


def cell(bench: dict, name: str, root=ROOT) -> dict:
    """The cell `name` with its configuration and traffic files loaded."""
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    w = dict(wl[name])
    cfgs = {c["name"]: c for c in bench["configs"]}
    w["cfg"] = load_json(root, cfgs[w["config"]]["file"])
    w["trf"] = load_json(root, "mdbench", "workloads", w["traffic"] + ".json")
    w["root"] = root
    return w


def end_to_end(bench: dict, name: str) -> list:
    return [m for m in bench["end_to_end"]
            if name in m.get("workloads", [name])]


def per_layer(bench: dict, name: str) -> list:
    return [m for m in bench["per_layer"] if name in m["workloads"]]


@functools.lru_cache(maxsize=None)
def _load(path: str):
    key = "mdbench_" + os.path.relpath(path, ROOT).replace(os.sep, "_") \
        .replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find(kind: str, name: str, root=ROOT):
    """The module mdbench/<kind>/<name>.py, '/' in a name read as '_'."""
    path = os.path.join(root, "mdbench", kind, name.replace("/", "_") + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind} {name!r}: {path} is missing")
    return _load(path)


def quantity(name: str) -> str:
    """What a metric measures: its name before any '.'."""
    return name.split(".")[0]


def reader(name: str, root=ROOT):
    return find("metrics", quantity(name), root).read


def fix_modules(cfg: dict, root=ROOT) -> list:
    return [(fc, find("fixes", fc["style"], root)) for fc in cfg["fixes"]]


# -- inputs --------------------------------------------------------------------
def inputs(cfg: dict, seed: int, device, root=ROOT) -> dict:
    """Positions, types, box, masses and velocities, float64 on `device`,
    rounded to the configuration's dtype so that both sides get the same
    numbers."""
    sc = dict(cfg["scene"])
    x, types, h = find("scenes", sc.pop("kind"), root).make(device=device,
                                                            **sc)
    dtype = getattr(torch, cfg["dtype"])
    mass = torch.tensor([0.0, *cfg["masses"]], dtype=torch.float64,
                        device=device)
    u = UNITS[cfg["units"]]
    v = velocities(types, mass, cfg["temperature"], u.boltz, u.mvv2e, seed,
                   device)
    return dict(x=x.to(dtype).double(), v=v.to(dtype).double(), types=types,
                h=h, mass=mass, dtype=dtype)


def velocities(types, mass_of_type, temperature: float, boltz: float,
               mvv2e: float, seed: int, device) -> torch.Tensor:
    """Float64 [N, 3] velocities at exactly `temperature`: Gaussian
    components over sqrt(m) from a torch.Generator on the device, zero
    total momentum, scaled over 3N - 3 degrees of freedom.  Every seed
    gives the same atoms; only the velocities differ."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 63)
    m = mass_of_type.to(torch.float64)[types]
    v = torch.randn((len(types), 3), generator=g, dtype=torch.float64,
                    device=device) / torch.sqrt(m)[:, None]
    v = v - (m[:, None] * v).sum(0) / m.sum()
    t_now = mvv2e * float((m[:, None] * v * v).sum()) / (
        (3 * len(types) - 3) * boltz)
    return v * math.sqrt(temperature / t_now)


def start_state(cfg: dict, inp: dict, root=ROOT) -> dict:
    """The state the program starts from, as the reference reads it."""
    ext = {}
    for fc, mod in fix_modules(cfg, root):
        ext.update(mod.start(fc, inp["x"].device))
    return dict(x=inp["x"], v=inp["v"], ext=ext)


# -- the program ---------------------------------------------------------------
def program_pair(cfg: dict, dtype, device, root=ROOT):
    pc = cfg["pair"]
    return find("styles", pc["style"], root).program(pc, root, dtype, device)


def program_fixes(cfg: dict, root=ROOT) -> list:
    return [mod.program(fc) for fc, mod in fix_modules(cfg, root)]


def snapshot(eng, cfg: dict, root=ROOT) -> dict:
    """An Engine's state as float64 copies: unwrapped positions,
    velocities, forces, and each fix's own state."""
    st = eng.state
    h = torch.tensor(st.box.h64, dtype=torch.float64, device=st.x.device)
    ext = {}
    for fc, mod in fix_modules(cfg, root):
        ext.update(mod.snapshot(fc, st.extras))
    return dict(x=st.x.double() + st.image.double() @ h,
                v=st.v.double().clone(), f=st.f.double().clone(), ext=ext,
                step=int(eng.step), rebuilds=int(eng.rebuilds))


# -- the reference -------------------------------------------------------------
def reference_potential(cfg: dict, devices, root=ROOT):
    """The configuration's plain reference, spread over `devices` (the
    cell's cards, in order)."""
    pc = cfg["pair"]
    return find("styles", pc["style"], root).reference(pc, root, devices)


def reference_integrator(cfg: dict, inp: dict, pot, dtype=torch.float64,
                         root=ROOT):
    thermostats = [t for t in (mod.reference(fc)
                               for fc, mod in fix_modules(cfg, root))
                   if t is not None]
    return Integrator(pot, inp["h"], inp["types"], inp["mass"],
                      UNITS[cfg["units"]], cfg["dt"], cfg["skin"],
                      cfg["list_rule"], thermostats=thermostats, dtype=dtype)


def follow(cfg, inp, pot, start: dict, k: int, dtype=torch.float64,
           root=ROOT):
    """The reference's k steps from `start`: (end MDState, forces at the
    start positions, the integrator, which keeps the lists it used)."""
    integ = reference_integrator(cfg, inp, pot, dtype, root)
    s, f0 = integ.follow(MDState(x=start["x"], v=start["v"],
                                 ext=dict(start["ext"])), k)
    return s, f0, integ


def compare(cfg, inp, pot, start: dict, got: dict, k: int,
            root=ROOT) -> dict:
    """The numbers of one check: `got` (the program's state k steps after
    `start`) against the float64 reference from `start`."""
    ref, f0, integ = follow(cfg, inp, pot, start, k, root=root)
    f_at = integ.forces(got["x"])
    fr = rms(f_at)
    df = (got["f"] - f_at).norm(dim=1)
    out = dict(f_rms=rms(got["f"] - f_at) / fr,
               f_max=float(df.max()) / fr,
               x_max=float((got["x"] - ref.x).norm(dim=1).max()),
               v_rms=rms(got["v"] - ref.v) / rms(ref.v))
    if cfg["list_rule"] == "exact" and "f_start" in got:
        out["f_window"] = float((got["f_start"] - f0).norm(dim=1).max()) / \
            rms(f0)
    return out


def control_state(cfg, inp, pot, start: dict, k: int, root=ROOT) -> dict:
    """The reference in bfloat16 in the program's place: its state k
    steps after `start`, and its forces at the start positions."""
    s, f0, _ = follow(cfg, inp, pot, start, k, dtype=torch.bfloat16,
                      root=root)
    return dict(x=s.x, v=s.v, f=s.f, f_start=f0)


def worst(a: dict, b: dict) -> dict:
    return {key: max(a.get(key, -math.inf), b.get(key, -math.inf))
            for key in set(a) | set(b)}


# -- spans, the card, the process ----------------------------------------------
def cuda_span_ms(fn, reps=SPAN_REPS) -> list:
    """Device ms of fn() by CUDA events, `reps` times."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def engine_spans(eng) -> dict:
    """The pair style's force call and one rebuild on the Engine's end
    state and lists, by CUDA events."""
    st = eng.state
    return dict(pair_forces_ms=cuda_span_ms(
        lambda: eng.pair.forces(st.x, st.type, eng.nbr, st.box.h)),
        rebuild_ms=cuda_span_ms(eng.rebuild_neighbors))


def power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def free_program():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def loaded_forbidden() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def now() -> float:
    return time.perf_counter()
