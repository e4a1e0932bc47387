"""Collectives of the sharded engine's per-device placement
(parallel/per_device.py): ppermute, psum and pmax between shards that each
keep their rows on their own device and CUDA stream, and the lock-step
runner that drives one program per shard through them.

The JAX engine runs one program per device under shard_map and its
collectives are XLA's.  Here each shard's program is a Python thread
(`Lockstep.run`).  The threads take turns in shard order: a thread runs
until its next collective, leaves its operand and hands the turn on; the
last shard to arrive runs the collective, and the turn comes back to shard
0.  So one thread runs at a time, every run makes the same calls in the
same order, and a shard's work between two collectives is one stretch of
its own, which `Lockstep.capture` records as one CUDA graph per shard and
piece (`Program`; the host replays the pieces in order and runs the
collectives between them).  The device work still overlaps: each shard
enqueues on its own stream.

A collective (`Collective.run`) records an event on every sender's stream,
makes each receiver's stream wait on the events of the shards it reads,
copies with `dst.copy_(src, non_blocking=True)` on the receiver's stream
into outputs allocated once on the receiver's device, and makes every
sender's stream wait on an event recorded after the copies, so that a
sender neither rewrites nor frees a tensor before its receivers read it.
psum and pmax bring every shard's operand to every device and reduce them
in shard order 0..Pn-1: every shard holds the same bits, and reruns match
bit for bit (no float atomics, no NCCL).  A CPU shard takes part through
synchronous copies (the `[card, cpu]` check of chip_smoke.py).

A run given span slots (one int64 [3] tensor a shard, `Lockstep.run(...,
slots=)`) stamps every collective on each receiving shard's stream
(run/timers.stamp): slot[COLLECTIVE] from before its event waits to after
its copies, slot[COPY] from after the waits, the copies and reductions
alone.  The stamps are kernels on that stream, so a replayed program's
collectives are timed on the device with no host read of their own.

A failure in one thread aborts the others and raises in the caller; no
turn for `timeout` seconds raises TimeoutError there, so a hung shard
never hangs the caller (its thread, a daemon, is left behind).
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, List, Sequence

import torch

from ..run.device_loop import _add_launches, _launch_counts
from ..run.timers import stamp

#: a shard's span slot: the indices of its stamped spans (Pair.forces,
#: Comm.collective, Comm.copy)
FORCES, COLLECTIVE, COPY = 0, 1, 2


class ShardGroup:
    """The shards' devices and streams (a new stream on each CUDA shard,
    None on a CPU shard), and each shard's kernel launches by wrapper
    module (`launches`, in run/device_loop.KERNEL_MODULES order), counted
    wherever its program runs."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self.streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                        else None for d in self.devices]
        self.launches = [[0] * len(_launch_counts()) for _ in self.devices]

    def __len__(self) -> int:
        return len(self.devices)

    @property
    def cuda(self) -> bool:
        """Every shard on a CUDA device (what a captured program needs)."""
        return all(s is not None for s in self.streams)

    @contextlib.contextmanager
    def on(self, d: int):
        """Shard d's device and stream as the calling thread's current
        ones (nothing on a CPU shard)."""
        s = self.streams[d]
        if s is None:
            yield
            return
        with torch.cuda.device(self.devices[d]), torch.cuda.stream(s):
            yield

    def synchronize(self):
        """Wait for every stream of the shards' CUDA devices."""
        for dev in dict.fromkeys(d for d in self.devices if d.type == "cuda"):
            torch.cuda.synchronize(dev)


class Collective:
    """One collective across the shards, its outputs allocated once on the
    receiving shards' devices; run() may run it again (a program's
    collectives run between its replayed pieces).

    kind "ppermute": operands[d] is a list of tensors and srcs one source
    map per tensor: output k of shard d is operand k of shard srcs[k][d].
    kind "psum" / "pmax": operands[d] is one tensor, and every shard's
    output is the sum / max of all of them in shard order.  slots: the
    shards' span slots, stamped at every run (module docstring), or None."""

    def __init__(self, group: ShardGroup, kind: str, operands, srcs=None,
                 slots=None):
        self.group, self.kind, self.operands, self.srcs = (
            group, kind, operands, srcs)
        self.slots = slots
        n = len(group)
        self.outputs = []
        for d in range(n):
            with group.on(d):
                dev = group.devices[d]
                if kind == "ppermute":
                    self.outputs.append([
                        torch.empty_like(operands[src[d]][k], device=dev)
                        for k, src in enumerate(srcs)])
                else:
                    self.outputs.append(torch.empty_like(operands[0],
                                                         device=dev))
        self.reads = [sorted({src[d] for src in srcs}) if kind == "ppermute"
                      else list(range(n)) for d in range(n)]
        self._ready = self._done = None

    def _bring(self, t, j: int, d: int, out=None):
        """Shard j's tensor t on shard d's device: `out` (or a new tensor,
        or t itself when the devices agree) written on shard d's stream;
        a copy to a CPU shard runs synchronously on the sender's stream."""
        g = self.group
        if out is None:
            if t.device == g.devices[d]:
                return t
            out = torch.empty_like(t, device=g.devices[d])
        if out.device.type == "cpu" and t.is_cuda:
            with g.on(j):
                out.copy_(t)
        else:
            out.copy_(t, non_blocking=True)
        return out

    def run(self):
        """Every output from the operands as they are on the senders'
        streams now; returns the outputs."""
        g, n = self.group, len(self.group)
        if self._ready is None:
            self._ready = [torch.cuda.Event() if s is not None else None
                           for s in g.streams]
            self._done = [torch.cuda.Event() if s is not None else None
                          for s in g.streams]
        for j, s in enumerate(g.streams):
            if s is not None:
                self._ready[j].record(s)
        for d in range(n):
            s = g.streams[d]
            slot = self.slots[d] if self.slots is not None else None
            with g.on(d):
                if slot is not None:
                    stamp(slot[COLLECTIVE], -1)
                if s is not None:
                    for j in self.reads[d]:
                        if g.streams[j] is not None and g.streams[j] != s:
                            s.wait_event(self._ready[j])
                if slot is not None:
                    stamp(slot[COPY], -1)
                if self.kind == "ppermute":
                    for k, src in enumerate(self.srcs):
                        self._bring(self.operands[src[d]][k], src[d], d,
                                    self.outputs[d][k])
                else:
                    acc = None
                    for j in range(n):
                        t = self._bring(self.operands[j], j, d)
                        acc = t if acc is None else (
                            acc + t if self.kind == "psum"
                            else torch.maximum(acc, t))
                    self.outputs[d].copy_(acc)
                if slot is not None:
                    stamp(slot[COPY], 1)
                    stamp(slot[COLLECTIVE], 1)
                if s is not None:
                    self._done[d].record(s)
        for d in range(n):
            if g.streams[d] is None:
                continue
            for j in self.reads[d]:
                sj = g.streams[j]
                if sj is not None and sj != g.streams[d]:
                    sj.wait_event(self._done[d])
        return self.outputs


class Program:
    """A captured run of one function per shard: pieces[d][i] is shard d's
    CUDA graph of its work between collectives i - 1 and i, launches[d][i]
    the kernel launches it replays (by wrapper module); `results` what the
    function returned, on the program's own tensors."""

    def __init__(self, group: ShardGroup):
        self.group = group
        n = len(group)
        self.pools = [torch.cuda.graph_pool_handle() for _ in range(n)]
        self.pieces: List[list] = [[] for _ in range(n)]
        self.launches: List[list] = [[] for _ in range(n)]
        self.collectives: List[Collective] = []
        self.results = None

    def replay(self):
        """Piece 0 of every shard, collective 0, piece 1, ...: one graph
        launch a shard and piece on the shard's stream."""
        g = self.group
        for i in range(len(self.collectives) + 1):
            for d, pieces in enumerate(self.pieces):
                with g.on(d):
                    pieces[i].replay()
            if i < len(self.collectives):
                self.collectives[i].run()
        for d, counts in enumerate(self.launches):
            for c in counts:
                _add_launches(c)
                g.launches[d] = [a + b for a, b in zip(g.launches[d], c)]

    def graph_launches(self) -> int:
        """Host graph launches a replay makes."""
        return sum(len(p) for p in self.pieces)

    def close(self):
        for pieces in self.pieces:
            for p in pieces:
                p.reset()
        self.pieces = [[] for _ in self.pieces]


class _Abort(Exception):
    """Raised in a shard's thread when the run failed elsewhere."""


class ShardComm:
    """Shard d's side of the collectives in a Lockstep run: each call
    blocks until every shard made the same call, and returns shard d's
    output (on its device)."""

    def __init__(self, run: "_Run", d: int):
        self._run, self.d = run, d

    def ppermute(self, items) -> list:
        """items: [(tensor, src)], src[e] the shard whose tensor shard e
        receives (the same maps on every shard); returns the received
        tensors in order."""
        return self._run.collective(
            self.d, "ppermute", [t for t, _ in items],
            [list(src) for _, src in items])

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return self._run.collective(self.d, "psum", t)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return self._run.collective(self.d, "pmax", t)


class _Run:
    """The shared state of one lock-step run (see Lockstep)."""

    def __init__(self, group: ShardGroup, timeout: float,
                 program: Program | None, span_slots=None):
        self.group, self.timeout, self.program = group, timeout, program
        self.span_slots = span_slots
        self.n = len(group)
        self.cond = threading.Condition()
        self.turn = 0
        self.last_turn = time.monotonic()
        self.error: BaseException | None = None
        self.slots = [None] * self.n
        self.outputs = None
        self.finished = [False] * self.n
        self.results = [None] * self.n
        self.open = [None] * self.n     # (graph or None, counts at start)

    # -- turns ------------------------------------------------------------
    def wait(self, d: int):
        with self.cond:
            ok = self.cond.wait_for(
                lambda: self.error is not None or self.turn == d,
                timeout=self.timeout)
            if self.error is None and not ok:
                self.error = TimeoutError(
                    f"shard {d} waited {self.timeout} s for its turn: "
                    f"shard {self.turn} hangs")
                self.cond.notify_all()
            if self.error is not None:
                raise _Abort

    def pass_turn(self, d: int):
        """Hand the turn to shard d + 1 (the caller holds cond)."""
        self.turn = (d + 1) % self.n
        self.last_turn = time.monotonic()
        self.cond.notify_all()

    def fail(self, e: BaseException):
        with self.cond:
            if self.error is None:
                self.error = e
            self.cond.notify_all()

    # -- pieces (captured graphs, or the launches counted eagerly) ---------
    def begin(self, d: int):
        graph = None
        counts = _launch_counts()
        if self.program is not None:
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=self.program.pools[d],
                                capture_error_mode="thread_local")
        self.open[d] = (graph, counts)

    def end(self, d: int):
        graph, before = self.open[d]
        self.open[d] = None
        if graph is not None:
            graph.capture_end()
        delta = [b - a for a, b in zip(before, _launch_counts())]
        if self.program is not None:
            # a capture launches nothing: its counts come with each replay
            _add_launches([-c for c in delta])
            self.program.pieces[d].append(graph)
            self.program.launches[d].append(delta)
        else:
            g = self.group
            g.launches[d] = [a + b for a, b in zip(g.launches[d], delta)]

    def abandon(self, d: int):
        """End a capture left open by a failure (its graph is dropped)."""
        graph = self.open[d][0] if self.open[d] else None
        self.open[d] = None
        if graph is not None:
            try:
                graph.capture_end()
            except RuntimeError:       # an invalidated capture: it is ended
                pass

    # -- collectives -----------------------------------------------------
    def collective(self, d: int, kind: str, operand, srcs=None):
        self.end(d)
        with self.cond:
            self.slots[d] = (kind, operand, srcs)
            if d == self.n - 1:
                self._run_collective()
            self.pass_turn(d)
        self.wait(d)
        out = self.outputs[d]
        self.begin(d)
        return out

    def _run_collective(self):
        kinds = {(s[0], repr(s[2])) for s in self.slots if s is not None}
        if any(self.finished) or None in self.slots or len(kinds) != 1:
            raise RuntimeError(
                "the shards reached different collectives: "
                f"{[s and s[0] for s in self.slots]}, finished "
                f"{self.finished}")
        kind, _, srcs = self.slots[0]
        op = Collective(self.group, kind, [s[1] for s in self.slots], srcs,
                        self.span_slots)
        if self.program is not None:
            self.program.collectives.append(op)
        else:
            op.run()
        self.outputs = op.outputs
        self.slots = [None] * self.n

    # -- a shard's thread --------------------------------------------------
    def thread(self, d: int, fn: Callable):
        try:
            self.wait(d)
            with self.group.on(d):
                self.begin(d)
                try:
                    out = fn(d, ShardComm(self, d))
                    self.end(d)
                except BaseException:
                    self.abandon(d)
                    raise
            self.results[d] = out
            with self.cond:
                self.finished[d] = True
                self.pass_turn(d)
        except _Abort:
            pass
        except BaseException as e:        # re-raised in the caller
            self.fail(e)


class Lockstep:
    """Runs fn(d, comm) for every shard d, each in its own thread, in
    lock-step at the collectives (module docstring)."""

    def __init__(self, group: ShardGroup, timeout: float = 600.0):
        self.group = group
        self.timeout = timeout

    def run(self, fn: Callable, slots=None) -> list:
        """[fn(d, comm) for every shard d], run eagerly; its collectives
        stamped into `slots` when given (module docstring)."""
        return self._go(fn, None, slots)

    def capture(self, fn: Callable, slots=None) -> Program:
        """fn's pieces captured (not run), one CUDA graph per shard and
        piece; its collectives recorded with their outputs (and stamped
        into `slots` at each replay when given); what fn returned in
        program.results.  Run fn eagerly first (its kernels
        built, the device caches of its fixes filled)."""
        if not self.group.cuda:
            raise RuntimeError("a captured program needs every shard on a "
                               "CUDA device")
        program = Program(self.group)
        self.group.synchronize()
        gc_enabled = gc.isenabled()
        gc.disable()    # no finalizer's CUDA call inside a capture
        try:
            program.results = self._go(fn, program, slots)
        except BaseException:
            program.close()
            raise
        finally:
            if gc_enabled:
                gc.enable()
        return program

    def _go(self, fn, program, slots=None):
        r = _Run(self.group, self.timeout, program, slots)
        threads = [threading.Thread(target=r.thread, args=(d, fn),
                                    name=f"shard-{d}", daemon=True)
                   for d in range(r.n)]
        for t in threads:
            t.start()
        with r.cond:
            while r.error is None and not all(r.finished):
                r.cond.wait(timeout=min(1.0, self.timeout))
                if r.error is None and not all(r.finished) and (
                        time.monotonic() - r.last_turn > self.timeout):
                    r.error = TimeoutError(
                        f"no shard took a turn for {self.timeout} s: "
                        f"shard {r.turn} hangs")
                    r.cond.notify_all()
        for t in threads:
            t.join(timeout=1.0)
        if r.error is not None:
            raise r.error
        return r.results
