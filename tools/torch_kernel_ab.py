#!/usr/bin/env python3
"""Two or more builds of the REBO cotangent kernel (A), the pin copy (H),
the LJ cell sweeps (C, E), select-k (D), the rebuild's candidate
selection (D') and the reaction combine (G) on one card, on the same
inputs, timed in turns.

    python3 tools/torch_kernel_ab.py --tree LABEL=PATH [--tree ...]
        [--reps 60] [--k 16,20] [--only-candidates] [--explore]
        [--shapes main,aeam,melt,lj,wide_melt,skin4[,mono,shard0,ljcut7]]

This repository is the first build ("this"); each PATH is another tree
that holds lammps_plugins_tpu_torch/ (a `git archive` of the parent
commit, or a scratch copy with another design of a kernel).  Each tree's
own ops/build.py builds its csrc/*.cu into PATH/build/torch_kernels/, and
each library's entry points are called through ctypes with the arguments
of the tree's own signature (chip_smoke.py's launchers read it from the
tree's ops/build.py): lpt_rebo_cotangents, lpt_select_k and
lpt_select_candidates with or without the launch plan (atoms and staged
slots for A; warps and hit buffer for D, from this tree's ops/*.py plans;
D' as the earlier one-block-a-cell design, its own sort and plan
kept in chip_smoke.py, or the brick design with this tree's plan),
lpt_lj_cell_forces / lpt_lj_cell_forces_half with
or without a packing scratch and Dx, lpt_react_combine on the route
tables or on rtgt.  A tree without lpt_select_candidates takes the
candidate selection's unfused path (this tree's torch-built keys, then
that tree's select_k).  A build whose entry point refuses a shape (the
designs before any K: D and D' past K = 256, A past K = 64) is recorded
as "refused" there.

Inputs come from this tree.  The 97,920-atom bench scene
(chip_smoke.bench_engine) after one rebuild: A runs on the rebuild's
[K, Np] planes and on the same planes padded with empty slots to each
larger K of --k (what the Engine's K re-size gives); H on chip_smoke's
three phase-1 shapes; C (with and without the energy row) and E on the
scene's packed cell planes; D on chip_smoke's seeded candidate-like keys;
G on the route tables of the spatially sorted scene's rebuild.  D' runs
on the arguments of the rebuild of each cell's scene at its K: main (the
bench scene, K = 16), aeam (32,000 atoms, K = 144), melt (65,536 ions,
K = 128), lj (bench/in.lj, K = 120), and the wide shapes wide_melt
(chip_smoke.wide_melt: lj/cut/coul/cut 6 12, skin 2, K past 256) and
skin4 (the bench scene at skin 4.0), where A also runs on the rebuild's
own REBO planes (K past 64); --shapes also takes mono (the 1,000,518-atom
monolayer), shard0 (shard 0 of the bench scene in a 2 x 2 grid) and
ljcut7 (lj_melt(12) with lj/cut 7.0).  Each fused D' is also split into
its parts (chip_smoke.candidates_split: the sort, zero fills, kernel and
cnt.max of the one-block-a-cell design; the gather and kernel of the
brick design), and --explore times this build under every plan that fits
(tools' plans_to_explore).  --only-candidates times D' alone.  Every
launch of every build is timed with
CUDA events, one launch each per turn, the order reversed every other
turn, and clone() takes its turn beside the pin copies; the medians of
--reps turns are printed with each build's max error against this tree's
twin (A, C, E, G) or exactness (H, D, D'; G's bit-identity with this
tree's), the bound of each D' and A shape, and one line `RESULT {json}`
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="LABEL=PATH of another build")
    ap.add_argument("--reps", type=int, default=60)
    ap.add_argument("--k", default="16,20")
    ap.add_argument("--only-candidates", action="store_true",
                    help="time D' alone (no A, H, C, E, D or G)")
    ap.add_argument("--explore", action="store_true",
                    help="also time this build's D' under every plan that "
                         "fits (bricks, staged or not, 4, 8, 16 warps)")
    ap.add_argument("--shapes", default=",".join(ALL_SHAPES),
                    help="D' shapes, of " + ", ".join(ALL_SHAPES
                                                      + MORE_SHAPES))
    args = ap.parse_args()
    labels = [x for x in args.shapes.split(",") if x]
    sys.path.insert(0, REPO)
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from lammps_plugins_tpu_torch.ops import build, rebo
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: no CUDA device")
    dev = torch.device("cuda:0")
    trees = {"this": REPO}
    for spec in args.tree:
        label, path = spec.split("=", 1)
        trees[label] = os.path.abspath(path)
    libs, builds = {}, {}
    for label, tree in trees.items():
        b = build if label == "this" else cs.load_build(label, tree)
        libs[label], builds[label] = b.lib(), b
        print(f"built {label} from {tree}")
        if b.build_log:
            print(b.build_log, file=sys.stderr)

    eng = cs.bench_engine(dev)
    cand_args = cs.capture_candidate_calls(eng)[-1]
    out = {}
    if args.only_candidates:
        del eng
        out.update(time_candidate_shapes(builds, cand_args, args.reps, cs,
                                         dev, labels, rebo_skin4=False,
                                         explore=args.explore))
        return result(trees, args.reps, out)
    pair, st, nbr = eng.pair, eng.state, eng.nbr
    planes0 = pair._rebo_planes(st.x, pair.el_of_type[st.type], nbr.ghosts,
                                nbr.lists["rebo"], st.box.h)
    cst = pair._rebo_consts
    stream = build.stream(dev)
    K0, Np = planes0[0].shape
    out.update(rebo={}, pin={}, lj={})
    for K in sorted({K0, *(int(k) for k in args.k.split(",") if k)}):
        if K < K0:
            continue
        planes = [F.pad(p, (0, 0, 0, K - K0)).contiguous()
                  for p in planes0[:5]] + [planes0[5]]
        out["rebo"][K] = time_rebo(builds, planes, cst, args.reps, cs)
        del planes
    g = rebo.rebo_cotangents_ref(*planes0, cst)
    stacked = torch.stack(g, dim=-1)
    flat = stacked.reshape(-1)
    R = -(-flat.shape[0] // 128)
    Wr = 64 if 3 * K0 <= 64 else 128
    shapes = {
        f"[{R},128]": F.pad(flat, (0, R * 128 - flat.shape[0])).reshape(
            R, 128),
        f"[{K0},{3 * Np}]": stacked.reshape(K0, 3 * Np),
        f"[{Np},{Wr}]": F.pad(torch.cat(g).t(), (0, Wr - 3 * K0))
        .contiguous()}
    for shape, a in shapes.items():
        R_, L_ = a.shape
        dst = {lab: torch.empty_like(a) for lab in libs}

        def copier(lab):
            def fn():
                status = libs[lab].lpt_pin_copy(a.data_ptr(),
                                                dst[lab].data_ptr(), R_, L_,
                                                stream)
                build.raise_on_error(status, f"pin {lab}")
            return fn

        fns = {lab: copier(lab) for lab in libs}
        fns["clone"] = lambda: a.clone()
        for lab in libs:
            fns[lab]()
        torch.cuda.synchronize()
        exact = {lab: bool(torch.equal(dst[lab], a)) for lab in libs}
        ms = cs.interleaved_ms(fns, args.reps)
        b_ms = cs.bound(8 * a.numel(), 0)[0]
        out["pin"][shape] = dict(ms=ms, exact=exact, bound_ms=b_ms)
        print(f"pin {shape}: " + ", ".join(
            f"{lab} {t:.4f} ms" for lab, t in ms.items())
            + f"; exact {exact}; bound {b_ms:.4f} ms")
    out["lj"] = time_lj(builds, eng, args.reps, cs)
    del eng, planes0, g, stacked, flat, shapes
    out.update(time_select_react(builds, cand_args, K0, args.reps, cs, dev))
    out.update(time_candidate_shapes(builds, cand_args, args.reps, cs, dev,
                                     labels))
    return result(trees, args.reps, out)


def result(trees, reps, out):
    """Print the RESULT line with the card's name and power limit."""
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print("RESULT " + json.dumps(dict(trees=trees, reps=reps, gpu=gpu,
                                      **out)))


def refused_or(fn):
    """fn() once; "refused" when the build's entry point refuses the
    shape (a RuntimeError from its status), else None."""
    try:
        fn()
    except RuntimeError as err:
        print(f"  refused: {err}")
        return "refused"
    return None


def time_rebo(builds, planes, cst, reps, cs):
    """A of every build on the [K, Np] planes in turns: median ms, max
    error against this tree's twin (taken chip_smoke.REBO_TWIN_ATOMS
    atoms at a time), the bound; a build that refuses K is "refused"."""
    import torch
    from lammps_plugins_tpu_torch.ops import build, rebo
    K, Np = planes[0].shape
    cvec = build.device_constants(tuple(rebo.rebo_constant_vector(cst)),
                                  planes[0].device)
    fns = {lab: cs.rebo_launcher(b, planes, cvec, K, Np)
           for lab, b in builds.items()}
    refused = {lab: refused_or(fn) for lab, fn in fns.items()}
    fns = {lab: fn for lab, fn in fns.items() if not refused[lab]}
    outs = {lab: [o.clone() for o in fn()] for lab, fn in fns.items()}
    scale, errs = 0.0, {lab: 0.0 for lab in fns}
    for c0 in range(0, Np, cs.REBO_TWIN_ATOMS):
        c1 = c0 + cs.REBO_TWIN_ATOMS
        g = rebo.rebo_cotangents_ref(
            *[p[:, c0:c1].contiguous() for p in planes[:5]],
            planes[5][c0:c1], cst)
        scale = max(scale, max(float(t.abs().max()) for t in g))
        for lab, o in outs.items():
            errs[lab] = max(errs[lab], max(float((a[:, c0:c1] - b).abs()
                                                 .max())
                                           for a, b in zip(o, g)))
    del outs
    torch.cuda.synchronize()
    ms = cs.interleaved_ms(fns, reps)
    work = cs.rebo_work(planes, cst)
    b_ms, b_by = cs.bound(*work[:3])
    print(f"rebo K={K}: " + ", ".join(
        f"{lab} {ms[lab]:.4f} ms (err {errs[lab]:.3e})" for lab in fns)
        + "".join(f", {lab} refused" for lab, r in refused.items() if r)
        + f"; bar {5e-4 * scale:.3e}; bound {b_ms:.4f} ms by {b_by}")
    return dict(ms={**ms, **{lab: r for lab, r in refused.items() if r}},
                max_abs_err=errs, bar=5e-4 * scale, bound_ms=b_ms,
                bound_by=b_by, live_edges_hist=work[3])


#: D' shapes: the rebuild of each cell's scene at its K (ALL_SHAPES), and
#: three more that --shapes may name: the monolayer, shard 0 of the bench
#: scene in a 2x2 grid, and lj/cut 7.0 (chip_smoke.lj_wide_engine)
ALL_SHAPES = ("main", "aeam", "melt", "lj", "wide_melt", "skin4")
MORE_SHAPES = ("mono", "shard0", "ljcut7")


def candidate_shape(cs, dev, label, main_args):
    """(select_candidates arguments, engine) of the D' shape `label`."""
    def grab(eng, K=None, run=None):
        a = cs.capture_candidate_calls(eng, run)[0 if run else -1]
        return (a if K is None else a[:5] + (K,) + a[6:]), eng

    if label == "main":
        return main_args, None
    if label == "aeam":
        return grab(cs.aeam_engine(dev), 144)
    if label in ("melt", "lj"):
        return grab(cs.deck_engine(dev, label), dict(melt=128, lj=120)[label])
    if label == "wide_melt":
        return grab(cs.wide_melt(cs.DECKS["melt"], device=dev).engine())
    if label == "skin4":
        return grab(cs.bench_engine(dev, skin=cs.SKIN4["skin"]))
    if label == "mono":
        return grab(cs.mono_engine(dev))
    if label == "shard0":
        se = cs.shard_bench(dev, (2, 2))
        return grab(None, run=lambda: se._resettle(se.shards))
    if label == "ljcut7":
        return grab(cs.lj_wide_engine(dev))
    raise ValueError(f"unknown D' shape {label}")


def plans_to_explore(K, Cf, nt):
    """Every D' plan that fits a block: the bucket sort (where it fits),
    each mode and brick of ops/select_candidates.py, 4, 8 and 16 warps."""
    from lammps_plugins_tpu_torch.ops import select_candidates as sc
    cap = sc.hit_capacity(K)
    bucket = sc.candidates_plan(K, Cf, nt).bucket
    plans = []
    for staged, bricks in sc.MODES:
        for bx in bricks:
            for warps in (16, 8, 4):
                nb = sc.candidates_bytes(warps, cap, bucket, bx, staged, Cf,
                                         nt)
                if nb > sc.SMEM_LIMIT:
                    continue
                blocks = min(sc.SM_SMEM // (nb + sc.BLOCK_SMEM),
                             sc.SM_THREADS // (32 * warps),
                             sc.SM_REGS // (sc.REGS * 32 * warps))
                plans.append(sc.CandidatesPlan(warps, cap, bucket, bx,
                                               staged, nb, blocks))
    return plans


def explore_plans(b, cand_args, reps, cs):
    """{plan label: median ms} of this build's D' under every plan of
    plans_to_explore, in turns; each plan's lists exact against the
    twin's."""
    import torch
    from lammps_plugins_tpu_torch.ops import select_candidates
    K, Cf, nt = cand_args[5], cand_args[1].shape[1], cand_args[4].shape[0]
    ref = select_candidates.select_candidates_ref(*cand_args)
    fns = {}
    for p in plans_to_explore(K, Cf, nt):
        label = (f"{'staged' if p.staged else 'in place'} b{p.bx} "
                 f"w{p.warps} x{p.blocks_per_sm}")
        fns[label] = cs.brick_parts(b, cand_args, p)["wrapper"]
        if not all(torch.equal(x, y) for x, y in zip(fns[label](), ref)):
            raise AssertionError(f"D' under plan {label} differs")
    ms = cs.interleaved_ms(fns, reps)
    print("  plans: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                  sorted(ms.items(), key=lambda t: t[1])))
    return ms


def time_candidate_shapes(builds, main_args, reps, cs, dev, labels,
                          rebo_skin4=True, explore=False):
    """D' (or the unfused path) of every build in turns on each shape of
    `labels`, exact against this tree's twin, with its bound and each
    fused build's split (chip_smoke.candidates_split); explore: this
    build under every plan (explore_plans); then A on the skin-4.0
    rebuild's REBO planes."""
    import torch
    from lammps_plugins_tpu_torch.ops import select_candidates
    res = {"select_candidates": {}}
    skin4 = None
    for label in labels:
        cand_args, eng = candidate_shape(cs, dev, label, main_args)
        if label == "skin4":
            skin4 = eng
        del eng
        ref = select_candidates.select_candidates_ref(*cand_args)
        fns, design = {}, {}
        for lab, b in builds.items():
            fns[lab], design[lab] = cs.candidates_launcher(b, cand_args)
        refused = {lab: refused_or(fn) for lab, fn in fns.items()}
        fns = {lab: fn for lab, fn in fns.items() if not refused[lab]}
        exact = {lab: all(torch.equal(a, r) for a, r in zip(fn(), ref))
                 for lab, fn in fns.items()}
        ms = cs.interleaved_ms(fns, reps)
        split = {lab: cs.candidates_split(b, cand_args, reps)
                 for lab, b in builds.items() if not refused[lab]}
        work = cs.candidate_work(cand_args)
        b_ms, b_by = cs.bound(*work[:2])
        K, Cf = cand_args[5], cand_args[1].shape[1]
        res["select_candidates"][label] = dict(
            ms={**ms, **{lab: r for lab, r in refused.items() if r}},
            exact=exact, design=design, split=split, K=K, Cf=Cf,
            n=cand_args[2].shape[0], kmax=int(ref[3]), bound_ms=b_ms,
            bound_by=b_by)
        print(f"select_candidates {label} (K={K}, Cf={Cf}, kmax "
              f"{int(ref[3])}): " + ", ".join(
                  f"{lab} ({design[lab]}) {t:.4f} ms" for lab, t in
                  ms.items())
              + "".join(f", {lab} refused" for lab, r in refused.items()
                        if r)
              + f"; exact {exact}; bound {b_ms:.4f} ms by {b_by}; split "
              + "; ".join(f"{lab} " + ", ".join(
                  f"{p} {t:.4f}" for p, t in sp.items())
                  for lab, sp in split.items()))
        if explore:
            res["select_candidates"][label]["plans_ms"] = explore_plans(
                builds["this"], cand_args, max(reps // 2, 5), cs)
        del ref, fns, cand_args
        torch.cuda.empty_cache()
    if rebo_skin4 and skin4 is not None:
        pair, st, nbr = skin4.pair, skin4.state, skin4.nbr
        planes = pair._rebo_planes(st.x, pair.el_of_type[st.type],
                                   nbr.ghosts, nbr.lists["rebo"], st.box.h)
        res["rebo_skin4"] = time_rebo(builds, planes, pair._rebo_consts,
                                      reps, cs)
    return res


def time_lj(builds, eng, reps, cs):
    """C with and without the energy row, and E, from every build on the
    scene's packed cell planes; errors against this tree's twins."""
    import torch
    from lammps_plugins_tpu_torch.ops import lj_cells, lj_half
    pair, st, nbr = eng.pair, eng.state, eng.nbr
    P = pair._cell_planes(st.x, nbr.ghosts, nbr.cells, st.box.h)
    ar, lc = nbr.cells.a_range, pair._lj_consts
    ref_c = lj_cells.lj_cell_forces_ref(P, lc, ar, with_energy=True)
    ref = {"lj_cell_forces": ref_c, "lj_cell_forces+energy": ref_c,
           "lj_cell_forces_half": lj_half.lj_cell_forces_half_ref(P, lc, ar)}
    launchers = {lab: cs.lj_launchers(b, P, lc, ar)
                 for lab, b in builds.items()}
    res = {}
    for name, r in ref.items():
        fns = {lab: fn[name] for lab, fn in launchers.items()}
        outs = {lab: fn() for lab, fn in fns.items()}
        torch.cuda.synchronize()
        rows = ((...,) if name == "lj_cell_forces_half"
                else (..., slice(0, 3), slice(None)))
        errs = {lab: float((o[rows] - r[rows]).abs().max())
                for lab, o in outs.items()}
        e_rel = {}
        if name == "lj_cell_forces+energy":
            e_ref = float(r[..., 3, :].double().sum())
            e_rel = {lab: abs(float(o[..., 3, :].double().sum()) - e_ref)
                     / abs(e_ref) for lab, o in outs.items()}
        ms = cs.interleaved_ms(fns, reps)
        bar = 2e-4 * float(r[rows].abs().max())
        res[name] = dict(ms=ms, max_abs_err=errs, bar=bar,
                         energy_rel_err=e_rel)
        print(f"{name}: " + ", ".join(
            f"{lab} {ms[lab]:.4f} ms (err {errs[lab]:.3e}"
            + (f", energy rel {e_rel[lab]:.2e}" if e_rel else "") + ")"
            for lab in fns) + f"; bar {bar:.3e}")
    return res



def time_select_react(builds, cand_args, K, reps, cs, dev):
    """D on chip_smoke's keys (the bench rebuild's row count and width),
    G on the sorted scene's tables, every build in turns; each build's
    outputs against this tree's."""
    import torch
    from lammps_plugins_tpu_torch.ops import react, rebo, select_k
    res = {}
    N = cand_args[2].shape[0]
    W = -(-27 * cand_args[1].shape[1] // 128) * 128
    keys, ids, typ = cs.select_k_keys(dev, N, W)
    ref = select_k.select_k_ref(keys, K, (ids, typ))
    fns = {lab: cs.select_k_launcher(b, keys, K, (ids, typ))
           for lab, b in builds.items()}
    exact = {lab: all(torch.equal(a, r) for a, r in zip(fn(), ref))
             for lab, fn in fns.items()}
    ms = cs.interleaved_ms(fns, reps)
    res["select_k"] = dict(ms=ms, exact=exact, N=N, W=W, K=K)
    print("select_k: " + ", ".join(f"{lab} {t:.4f} ms" for lab, t in
                                   ms.items()) + f"; exact {exact}")
    del keys, ids, typ, ref, fns

    eng = cs.bench_engine(dev, sort=True, combine="react", react_gate=False)
    eng.rebuild_neighbors()
    pair, st, nbr = eng.pair, eng.state, eng.nbr
    rl = nbr.lists["rebo"]
    planes = pair._rebo_planes(st.x, pair.el_of_type[st.type], nbr.ghosts,
                               rl, st.box.h)
    g3 = rebo.rebo_cotangents(*planes, pair._rebo_consts)
    mine = react.react_combine(*g3, rl.rtgt)
    ref = react.react_combine_ref(*g3, rl.rblocks, rl.route)
    fns = {lab: cs.react_launcher(b, g3, rl) for lab, b in builds.items()}
    errs = {lab: float((fn() - ref).abs().max()) for lab, fn in fns.items()}
    same = {lab: bool(torch.equal(fn(), mine)) for lab, fn in fns.items()}
    ms = cs.interleaved_ms(fns, reps)
    bar = 1e-5 * float(ref.abs().max())
    res["react_combine"] = dict(ms=ms, max_abs_err=errs, bar=bar,
                                bit_identical_to_this=same)
    print("react_combine: " + ", ".join(
        f"{lab} {ms[lab]:.4f} ms (err {errs[lab]:.3e}, same as this "
        f"{same[lab]})" for lab in fns) + f"; bar {bar:.3e}")
    return res


if __name__ == "__main__":
    main()
