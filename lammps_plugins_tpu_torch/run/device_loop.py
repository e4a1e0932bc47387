"""The device loop (port of lammps_plugins_tpu/run/simulation.py,
`_device_loop_fn` and the loop half of `_run_span_device`, and of
lammps_plugins_tpu/parallel/sharded_engine.py, `_build_loop`).

`GraphIteration` holds what both loops share: the control vector, the
decision rule, the capture, the conditional node, replay and read.
`DeviceLoop` is the Engine's iteration; the sharded engine's, whose
rebuild is the resettle of every shard, is
parallel/sharded_engine.py::ShardLoop.

One iteration of the JAX loop body, on buffers that stay in place:

    if pending: rebuild the lists into the loop's neighbor buffers, max-merge
                the rebuild's flags, n_rb += 1, its device ns into rebuild_ns
    check_every steps (fixes and forces) from the loop's state
    md = max |x - x_build|^2 in float64;  tripped = md > (skin / 2)^2
    accept = pending | ~tripped   (a discarded segment keeps its start)
    done += accept * check_every
    d = sqrt(md); pending = (d + max(d - dprev, 0) > 0.95 skin / 2) | tripped;
    dprev = d

On a CUDA state the iteration is one CUDA graph.  PyTorch captures the
rebuild and the segment as two graphs sharing one memory pool, and
csrc/graph.cu joins them under an IF conditional node whose flag is
`pending`: the host launches the iteration m times without deciding
anything, then reads the control vector (done, pending, n_rb, dprev, the
ns of the rebuilds and of the steps' force calls, flags) in one copy.  The
two spans are stamps on the device's clock (run/timers.py) that ride in
the graph: the rebuild's inside the conditional node's body, so only the
rebuilds taken count.  On a CPU state the same code runs eagerly, with a
Python branch on `pending` in place of the conditional node.

The decisions are made in float64 from the float32 md, as the host loop
makes them with Python floats (float(md) is exact), so both loops take the
same rebuilds and give the same trajectory bit for bit.

The loop carries the state that a step changes: x, v, f and every tensor
of state.extras (a fix's own state, e.g. fix nvt's chain and step count),
in its buffers, its snapshot (restored when an overflow discards a span)
and its accept/discard step; image, which the rebuild changes, and the
inputs (x, image) of the last rebuild (`rb_in`, which the Engine re-lists
from after a re-size), in its buffers and snapshot.

What the captured code may do: read and write device tensors only.  The
kernel wrappers' `launches` counters tick once at capture; the loop puts
them back and adds each graph's launches at every replay (the rebuild's
n_rb times).  A fix whose hooks read a host value (`Fix.capturable`
False), a step that changes another State field, or one that changes the
keys, shapes or types of state.extras (or keeps a non-tensor in it), is
refused.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import importlib
import math
import time

import numpy as np
import torch

from ..ops import build
from .timers import device_span, stamp

#: the kernel wrapper modules of ops/ (each with a `launches` counter)
KERNEL_MODULES = ("rebo", "mirror", "lj_cells", "select_k",
                  "select_candidates", "lj_half", "mirror_rows", "react",
                  "pin", "ljcut")
_STATE_FIELDS = ("x", "v", "f")
_RB_IN = ("rb_x", "rb_image")                   # the last rebuild's inputs
#: ctl[0:6]; flags follow
_CTL = ("done", "pending", "n_rb", "dprev", "rebuild_ns", "forces_ns")


def kernel_modules():
    return [importlib.import_module(f"lammps_plugins_tpu_torch.ops.{m}")
            for m in KERNEL_MODULES]


def _launch_counts():
    return [m.launches for m in kernel_modules()]


def _add_launches(counts, times=1):
    for m, c in zip(kernel_modules(), counts):
        m.launches += c * times


def tensors(obj):
    """Every tensor of a neighbor structure (NeighborData and the
    dataclasses and dicts inside it) in a fixed order."""
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, dict):
        for k in sorted(obj):
            yield from tensors(obj[k])
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from tensors(getattr(obj, f.name))


def extras_items(extras, prefix=()):
    """[(key path, tensor)] of every tensor of a (nested) state.extras
    dict, in sorted key order; a leaf that is not a tensor raises."""
    out = []
    for k in sorted(extras):
        path, v = prefix + (k,), extras[k]
        if isinstance(v, dict):
            out += extras_items(v, path)
        elif torch.is_tensor(v):
            out.append((path, v))
        else:
            raise RuntimeError(f"fused loop: state.extras{list(path)} is a "
                               f"{type(v).__name__}; the loop carries "
                               "tensors only")
    return out


def _nested(items):
    """The extras dict of extras_items' (key path, tensor) pairs."""
    out = {}
    for path, t in items:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = t
    return out


def _cloned(obj):
    """A copy of a neighbor structure with every tensor cloned."""
    if torch.is_tensor(obj):
        return obj.clone()
    if isinstance(obj, dict):
        return {k: _cloned(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _cloned(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def device_seconds(fn, device) -> float:
    """Seconds of device time of fn() on a CUDA device (events around it,
    queued behind a spin kernel so that they do not read the host's time
    to launch), host-clock seconds on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(60_000_000)            # ~30 ms at 1.98 GHz
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return 1e-3 * a.elapsed_time(b)


@dataclasses.dataclass
class SpanResult:
    done: int
    pending: bool
    n_rb: int
    dprev: float
    rebuild_s: float       # device seconds of the n_rb rebuilds
    forces_s: float        # device seconds of the steps' force calls
    flags: dict


class GraphIteration:
    """One iteration of the loop body on buffers that stay in place, and,
    on a CUDA device, its graph: the rebuild under the conditional node on
    `pending`, then the segment.  A subclass holds the buffers and defines
    `_rebuild()` (rebuild into its buffers and `_merge_flags` the flags)
    and `_steps()` (check_every steps from its buffers; returns the new
    tensors of the buffers a step changes, by buffer key, and md, the
    largest squared displacement since the rebuild, in float64).  Both
    may launch kernels and read and write device tensors only.

    Built for one plan and configuration; anything else means a new
    iteration (Engine._device_loop, ShardedEngine._device_loop)."""

    def __init__(self, device, flag_names, check: int, skin: float):
        half2 = (0.5 * skin) ** 2
        self.half2, self.c95 = half2, 0.95 * math.sqrt(half2)
        self.check = check
        self.cuda = device.type == "cuda"
        self.names = list(flag_names)
        self.buf = {}                 # the carried tensors, by key
        self.snap = {}                # their copies at start()
        self.ctl = torch.zeros(len(_CTL) + len(self.names), dtype=torch.int64,
                               device=device)
        self.done, self.n_rb = self.ctl[0], self.ctl[2]
        self.rebuild_ns, self.forces_ns = self.ctl[4], self.ctl[5]
        self.flags = self.ctl[len(_CTL):]
        self.pending = torch.zeros((), dtype=torch.bool, device=device)
        self.dprev = torch.zeros((), dtype=torch.float64, device=device)
        self.graphs = ()
        self.exec = None
        self.rb_launches = self.seg_launches = None
        self.pool_bytes = 0
        self.capture_s = 0.0

    # -- the iteration --------------------------------------------------------
    def _rebuild(self):
        raise NotImplementedError

    def _steps(self):
        raise NotImplementedError

    def _timed_rebuild(self):
        with device_span(self.rebuild_ns):
            self._rebuild()

    def _merge_flags(self, flags):
        """Max-merge a rebuild's flags into the control vector; n_rb += 1."""
        if sorted(flags) != self.names:
            raise RuntimeError(f"fused loop: rebuild flags {sorted(flags)} "
                               f"are not the loop's {self.names}")
        new = torch.stack([flags[k].to(torch.int64).reshape(())
                           for k in self.names])
        self.flags.copy_(torch.maximum(self.flags, new))
        self.n_rb.add_(1)

    def _segment(self):
        """check_every steps from the buffers, then the decisions."""
        b = self.buf
        new, md = self._steps()
        tripped = md > self.half2
        accept = self.pending | ~tripped
        for a, t in new:
            b[a].copy_(torch.where(accept, t, b[a]))
        self.done.add_(accept.to(torch.int64) * self.check)
        d = torch.sqrt(md)
        growth = torch.clamp(d - self.dprev, min=0.0)
        pending = (d + growth > self.c95) | tripped
        self.pending.copy_(pending)
        self.dprev.copy_(d)
        self.ctl[1].copy_(pending)
        self.ctl[3].copy_(d.view(torch.int64))

    # -- CUDA graph -----------------------------------------------------------
    def _capture(self, warm):
        """Run warm() (every kernel and cache of the iteration, eagerly),
        capture the rebuild and the segment, and join them under the
        conditional node."""
        warm()
        stamp(self.rebuild_ns, 0)     # the stamp kernel loaded, not captured
        lib = build.lib()
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()      # as torch.cuda.graph does on entry
        reserved = torch.cuda.memory_reserved()
        before = _launch_counts()
        pool = torch.cuda.graph_pool_handle()
        rb = torch.cuda.CUDAGraph(keep_graph=True)
        seg = torch.cuda.CUDAGraph(keep_graph=True)
        # A finalizer that the cyclic collector runs inside a capture (a
        # CUDA object of an earlier loop released) can make a CUDA call
        # that global capture mode refuses, and the capture is lost: the
        # collector stays off until both captures end.
        gc_enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(rb, pool=pool):
                self._timed_rebuild()
            mid = _launch_counts()
            with torch.cuda.graph(seg, pool=pool):
                self._segment()
        finally:
            if gc_enabled:
                gc.enable()
        after = _launch_counts()
        for m, c in zip(kernel_modules(), before):
            m.launches = c
        self.rb_launches = [m - a for a, m in zip(before, mid)]
        self.seg_launches = [z - m for m, z in zip(mid, after)]
        self.graphs = (rb, seg)
        top, exe = ctypes.c_void_p(), ctypes.c_void_p()
        build.raise_on_error(lib.lpt_graph_if_then(
            rb.raw_cuda_graph(), seg.raw_cuda_graph(),
            self.pending.data_ptr(), ctypes.byref(top)), "lpt_graph_if_then")
        self.top = top
        build.raise_on_error(lib.lpt_graph_instantiate(top, ctypes.byref(exe)),
                             "lpt_graph_instantiate")
        self.exec = exe
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.capture_s = time.perf_counter() - t0

    def close(self):
        """Release the executable, the joined graph and the pool."""
        if self.exec is not None:
            build.raise_on_error(build.lib().lpt_graph_destroy(self.top,
                                                               self.exec),
                                 "lpt_graph_destroy")
            self.exec = None
        for g in self.graphs:
            g.reset()
        self.graphs = ()

    def __del__(self):
        try:
            self.close()
        except Exception:       # interpreter shutdown: nothing left to free
            pass

    # -- driving --------------------------------------------------------------
    def _load(self, src_of, pending: bool, dprev: float):
        """Copy each buffer's source (where it is not the buffer itself)
        in, snapshot the buffers that restore() brings back (`snap`), set
        pending/dprev, zero the counters."""
        for a, t in self.buf.items():
            src = src_of[a]
            if src is not t:
                t.copy_(src)
            if a in self.snap:
                self.snap[a].copy_(t)
        self.pending.fill_(bool(pending))
        self.dprev.fill_(float(dprev))
        self.ctl.zero_()

    def replay(self, n: int):
        """n iterations: n graph launches (CUDA), or n eager iterations."""
        if self.cuda:
            lib = build.lib()
            stream = ctypes.c_void_p(build.stream(self.pending.device))
            for _ in range(n):
                build.raise_on_error(lib.lpt_graph_launch(self.exec, stream),
                                     "lpt_graph_launch")
            _add_launches(self.seg_launches, n)
            return
        for _ in range(n):
            if bool(self.pending):
                self._timed_rebuild()
            self._segment()

    def read(self) -> SpanResult:
        """The control vector in one copy to the host; the rebuild graph's
        launches counted n_rb times."""
        v = self.ctl.cpu().numpy()
        n_rb = int(v[2])
        if self.cuda:
            _add_launches(self.rb_launches, n_rb)
        return SpanResult(
            done=int(v[0]), pending=bool(v[1]), n_rb=n_rb,
            dprev=float(np.array(v[3:4]).view(np.float64)[0]),
            rebuild_s=1e-9 * int(v[4]), forces_s=1e-9 * int(v[5]),
            flags=dict(zip(self.names, (int(x) for x in v[len(_CTL):]))))

    def restore(self):
        """Back to the snapshot start() took (a discarded span)."""
        for a, t in self.snap.items():
            self.buf[a].copy_(t)

    def nbytes(self) -> int:
        """Device bytes of the loop's own: snapshot (extras included),
        control, graph pool."""
        return (sum(t.numel() * t.element_size() for t in self.snap.values())
                + self.ctl.numel() * 8 + 9 + self.pool_bytes)


class DeviceLoop(GraphIteration):
    """The Engine's iteration: its buffers and, on a CUDA state, its graph.
    Built by the Engine for one plan, pair style, fix list, dt, skin and
    check_every (Engine._device_loop); anything else means a new loop."""

    def __init__(self, eng, flag_names):
        st = eng.state
        super().__init__(st.x.device, flag_names, eng.check_every, eng.skin)
        self.eng = eng
        self.plan = eng._plan
        self.requests = eng.pair.neighbor_requests()
        bad = [type(f).__name__ for f in eng.fixes
               if not getattr(f, "capturable", True)]
        if bad:
            raise RuntimeError(f"fused loop: fixes {bad} read host values "
                               "in their hooks and cannot be captured")
        # the loop's state in place: x, v, f, image and the extras tensors
        # (keyed by their key paths); type, mass, box as given
        self.xpaths = [p for p, _ in extras_items(st.extras)]
        self.buf = {a: getattr(st, a).clone()
                    for a in _STATE_FIELDS + ("image",)}
        self.buf.update(zip(_RB_IN, (t.clone() for t in eng._rb_in)))
        self.buf.update((p, t.clone()) for p, t in extras_items(st.extras))
        self.snap = {a: t.clone() for a, t in self.buf.items()}
        self.base = self._state(st)
        self.nbr = _cloned(eng.nbr)
        self.step0 = st.step
        if self.cuda:
            self._capture(self._warm)

    # -- the iteration --------------------------------------------------------
    def _rebuild(self):
        """Rebuild into the loop's neighbor buffers; max-merge the flags."""
        b = self.buf
        xw, image, nbr, flags = self.eng.rebuild_lists(
            self.plan, b["x"], b["image"], self.base.type, self.requests)
        b["rb_x"].copy_(b["x"])
        b["rb_image"].copy_(b["image"])
        b["x"].copy_(xw)
        b["image"].copy_(image)
        for dst, src in zip(tensors(self.nbr), tensors(nbr), strict=True):
            dst.copy_(src)
        self._merge_flags(flags)

    def _steps(self):
        """check_every steps from the loop's state."""
        b = self.buf
        st = self.base
        with torch.no_grad():
            for _ in range(self.check):
                st = self.eng._one_step(st, self.nbr, self.forces_ns)
        moved = [f.name for f in dataclasses.fields(st)
                 if f.name not in _STATE_FIELDS + ("step", "extras")
                 and getattr(st, f.name) is not getattr(self.base, f.name)]
        new = dict(extras_items(st.extras))
        if list(new) != self.xpaths or any(
                t.shape != b[p].shape or t.dtype != b[p].dtype
                for p, t in new.items()):
            moved.append("the keys, shapes or types of extras")
        if moved:
            raise RuntimeError(f"fused loop: a step changed {moved}; the "
                               "loop carries x, v, f and the extras tensors")
        dd = st.x - self.nbr.x_build
        md = torch.max(torch.sum(dd * dd, dim=-1)).double()
        return ([(a, getattr(st, a)) for a in _STATE_FIELDS]
                + list(new.items())), md

    def _warm(self):
        """Every kernel and cache of the iteration, eagerly."""
        e, b = self.eng, self.buf
        with torch.no_grad():
            e.rebuild_lists(self.plan, b["x"], b["image"], self.base.type,
                            self.requests)
            e.pair.forces(b["x"], self.base.type, self.nbr, self.base.box.h)

    # -- driving --------------------------------------------------------------
    def _state(self, st):
        """st with x, v, f, image and extras on the loop's buffers."""
        return st.replace(
            extras=_nested((p, self.buf[p]) for p in self.xpaths),
            **{a: self.buf[a] for a in _STATE_FIELDS + ("image",)})

    def start(self, state, nbr, pending: bool, dprev: float):
        """Load the Engine's state and lists (copied where they are not the
        loop's own), the host's pending/dprev, and zero the counters.
        Returns the Engine's state on the loop's buffers."""
        src_of = dict(extras_items(state.extras))
        if list(src_of) != self.xpaths:
            raise RuntimeError(f"fused loop: state.extras holds "
                               f"{list(src_of)}, the loop {self.xpaths}")
        src_of.update(zip(_RB_IN, self.eng._rb_in))
        src_of.update((a, getattr(state, a))
                      for a in _STATE_FIELDS + ("image",))
        self._load(src_of, pending, dprev)
        if nbr is not self.nbr:
            for dst, src in zip(tensors(self.nbr), tensors(nbr), strict=True):
                dst.copy_(src)
        self.step0 = state.step
        return self._state(state)

    @property
    def rb_in(self):
        """(x, image) that the last rebuild of the loop's state took."""
        return self.buf["rb_x"], self.buf["rb_image"]
