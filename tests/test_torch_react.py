"""Block-sparse reaction combine of the port (ops/react.py) against JAX.

On the JAX package's own lists of the jiggled 288-atom scene (three
128-atom chunks): the port's build_route_tables equals JAX's output
exactly (counts-only mode too), every valid edge is routed exactly once to
the owner of its neighbour, route_by_target lists each routed entry once
under its target in (window, row, column) order within K rows, and both
twins (the target table's and the route tables') match the JAX kernel
(interpret mode) on the JAX REBO kernel's cotangents, 1e-5 x scale, and
each other in float64 to 1e-12.
The Engine: the first rebuild only measures, the plan then carries the
same route capacities as the JAX Engine under LPT_REACT=force, and a
combine="react" that the gate refuses raises.  REBOMoS.forces with
combine="react" against the default configuration (float64, 1e-10), and
20 NVE steps against the default trajectory (1e-9).  The sorted scene
matches the JAX package's under LPT_SORT_SCENE=1.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lammps_plugins_tpu_torch import convert
from lammps_plugins_tpu_torch.ops import react
from torch_parity import (assert_same_trajectory, config_forces_rel_err,
                          jax_engine, port_engine, rel_err, run_20_steps)


@pytest.fixture(scope="module")
def lists():
    """The JAX rebuild's rebo list, its port copy and the route caps."""
    from lammps_plugins_tpu.ops.react_pallas import build_route_tables
    jeng = jax_engine("bulk", "f32", jiggle=0.05)
    jl = jeng.nbr.lists["rebo"]
    owner = jeng.nbr.ghosts.owner
    n, K = jl.idx.shape
    counts = build_route_tables(jl.idx, jl.mask, jl.mirror, owner, n, K,
                                0, 0)[3:6]
    caps = react.choose_react(n, *(int(c) for c in counts), gate=False)
    pn = convert.neighbor_data_from_numpy(jeng.nbr, dtype=torch.float32)
    return jeng, jl, owner, pn, caps


def _port_tables(lists, caps):
    _, jl, _, pn, _ = lists
    pl = pn.lists["rebo"]
    n, K = pl.idx.shape
    return react.build_route_tables(pl.idx, pl.mask, pl.mirror,
                                    pn.ghosts.owner, n, K, *caps)


@pytest.mark.parametrize("measure_only", [False, True])
def test_route_tables_equal_jax(lists, measure_only):
    from lammps_plugins_tpu.ops.react_pallas import build_route_tables
    _, jl, owner, _, caps = lists
    caps = (0, 0, 0) if measure_only else caps
    n, K = jl.idx.shape
    out_j = build_route_tables(jl.idx, jl.mask, jl.mirror, owner, n, K,
                               *caps)
    out_p = _port_tables(lists, caps)
    assert len(out_p) == len(out_j) == 7
    for a, b in zip(out_p, out_j):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not bool(out_p[6])


def test_every_valid_edge_routed_once(lists):
    """Decoded routes are exactly the valid edges (source atom, slot,
    owner of the neighbour)."""
    _, _, _, pn, caps = lists
    pl = pn.lists["rebo"]
    rblocks, _, route = _port_tables(lists, caps)[:3]
    nch = route.shape[0]
    r = route.long()
    ok = r >= 0
    col = torch.arange(128)
    src = (rblocks.long()[:, :, None, None] * 128 + col).expand(r.shape)
    tgt = torch.arange(nch)[:, None, None, None] * 128 + (r & 255)
    routed = sorted(zip(src[ok].tolist(), (r >> 8)[ok].tolist(),
                        tgt[ok].tolist()))
    n = pl.idx.shape[0]
    owner_all = torch.cat([torch.arange(n), pn.ghosts.owner])
    valid = pl.mask & (pl.mirror >= 0)
    i, k = torch.nonzero(valid, as_tuple=True)
    edges = sorted(zip(i.tolist(), k.tolist(),
                       owner_all[pl.idx[i, k]].tolist()))
    assert len(edges) > 0 and routed == edges


def test_twin_matches_pallas_react_combine(lists):
    from lammps_plugins_tpu.ops.react_pallas import (build_route_tables,
                                                     react_combine)
    from lammps_plugins_tpu.ops.rebo_pallas import _rebo_call
    jeng, jl, owner, pn, caps = lists
    jp, js = jeng.pair, jeng.state
    n, K = jl.idx.shape
    Np = -(-n // 128) * 128
    pair = convert.rebomos_from_tables(jp.tables, jp.typemap_np,
                                       dtype=torch.float32)
    st = convert.state_from_numpy(js, dtype=torch.float32)
    planes = pair._rebo_planes(st.x, pair.el_of_type[st.type], pn.ghosts,
                               pn.lists["rebo"], st.box.h)
    eiT = np.zeros((8, Np), np.float32)
    eiT[0] = planes[5].numpy()
    g = _rebo_call(*(jnp.asarray(p.numpy()) for p in planes[:5]),
                   jnp.asarray(eiT),
                   consts_key=tuple(sorted(jp._rebo_consts.items())),
                   interpret=True)
    rb, qoff, route = build_route_tables(jl.idx, jl.mask, jl.mirror, owner,
                                         n, K, *caps)[:3]
    f_jax = np.asarray(react_combine(*g, rb, qoff, route, QR=caps[2],
                                     interpret=True))
    gt = [torch.from_numpy(np.array(a)) for a in g]
    rb_t, route_t = (torch.from_numpy(np.array(a)) for a in (rb, route))
    rtgt, _ = react.route_by_target(rb_t, route_t, K, Np)
    scale = np.abs(f_jax).max()
    assert scale > 1e-3
    # the wrapper (the twin of the target-table kernel on the CPU) and the
    # route-table twin
    for f_port in (react.react_combine(*gt, rtgt),
                   react.react_combine_ref(*gt, rb_t, route_t)):
        np.testing.assert_allclose(f_port.numpy(), f_jax, atol=1e-5 * scale,
                                   rtol=0)


def test_engine_route_capacities_match_jax(monkeypatch):
    """The first rebuild only measures; after it the plans of both Engines
    carry the same capacities (order-free counts of the same lists)."""
    monkeypatch.setenv("LPT_REACT", "force")
    jeng = jax_engine("small", "f64", jiggle=0.12)
    peng = port_engine("small", combine="react", react_gate=False)
    peng.rebuild_neighbors()
    caps = (peng._plan.react_nw, peng._plan.react_kc, peng._plan.react_qr)
    assert caps[0] > 0
    assert caps == (jeng._plan.react_nw, jeng._plan.react_kc,
                    jeng._plan.react_qr)
    rl = peng.nbr.lists["rebo"]
    assert rl.route.shape == (1, caps[0], caps[1], 128)


def test_gate_refusal_raises():
    eng = port_engine("small", combine="react")
    with pytest.raises(RuntimeError, match="refused"):
        eng.rebuild_neighbors()


def test_gate():
    assert react.choose_react(97920, 24, 8, 80) == (28, 10, 96)
    assert react.choose_react(97920, 45, 8, 80) == (0, 0, 0)
    assert react.choose_react(1000, 2, 4, 8) == (0, 0, 0)
    assert react.choose_react(1000, 2, 4, 8, gate=False) == (8, 6, 32)


@pytest.mark.parametrize("scene", ["small", "bulk"])
def test_forces_match_default_configuration(scene):
    cfg = dict(combine="react", react_gate=False)
    assert config_forces_rel_err(cfg, scene) <= 1e-10


def test_20_steps_match_default_trajectory():
    assert_same_trajectory(run_20_steps(combine="react", react_gate=False),
                           run_20_steps())


def test_sorted_scene_matches_jax(monkeypatch):
    from lammps_plugins_tpu.api.scenes import (
        rebomos_bulk_commensurate as jscene)
    from lammps_plugins_tpu_torch.api.scenes import rebomos_bulk_commensurate
    monkeypatch.setenv("LPT_SORT_SCENE", "1")
    js = jscene(4, 6, 2, dtype=jnp.float64)
    ps = rebomos_bulk_commensurate(4, 6, 2, dtype=torch.float64,
                                   device="cpu", sort=True)
    np.testing.assert_array_equal(ps.x.numpy(), np.asarray(js.x))
    np.testing.assert_array_equal(ps.type.numpy(), np.asarray(js.type))
    unsorted = rebomos_bulk_commensurate(4, 6, 2, dtype=torch.float64,
                                         device="cpu")
    assert not np.array_equal(ps.x.numpy(), unsorted.x.numpy())


def _routed_by_target(rblocks, route, Np):
    """{target atom: [flat plane index k * Np + source, ...]} of the route
    tables, each target's entries in table order (window, row, column)."""
    r = route.long()
    out = {}
    for c, w, kc, col in zip(*(a.tolist() for a in
                               torch.nonzero(r >= 0, as_tuple=True))):
        v = int(r[c, w, kc, col])
        src = int(rblocks[c, w]) * 128 + col
        out.setdefault(c * 128 + (v & 255), []).append((v >> 8) * Np + src)
    return out


def test_route_by_target_lists_each_entry_once_in_order(lists):
    """Every routed entry once, under its target, in (window, row, column)
    order, within K rows; a table cut short keeps each target's first
    entries and reports the depth it needed."""
    _, _, _, pn, caps = lists
    pl = pn.lists["rebo"]
    n, K = pl.idx.shape
    Np = -(-n // 128) * 128
    rblocks, _, route = _port_tables(lists, caps)[:3]
    expect = _routed_by_target(rblocks, route, Np)
    assert sum(len(v) for v in expect.values()) \
        == int((pl.mask & (pl.mirror >= 0)).sum()) > 0
    depth = max(len(v) for v in expect.values())
    assert depth <= K
    for Dt in (K, depth - 1):
        rtgt, need = react.route_by_target(rblocks, route, Dt, Np)
        assert rtgt.shape == (Dt, Np) and rtgt.dtype == torch.int32
        assert int(need) == depth
        for t in range(Np):
            want = expect.get(t, [])[:Dt]
            col = rtgt[:, t].tolist()
            assert col == want + [-1] * (Dt - len(want))


def test_target_twin_matches_route_twin_f64(lists):
    """On seeded float64 planes the target-table twin (and the wrapper on
    the CPU, which takes it) equals the route-table twin to 1e-12."""
    _, _, _, pn, caps = lists
    n, K = pn.lists["rebo"].idx.shape
    Np = -(-n // 128) * 128
    rblocks, _, route = _port_tables(lists, caps)[:3]
    rtgt, _ = react.route_by_target(rblocks, route, K, Np)
    rng = np.random.default_rng(11)
    g = [torch.from_numpy(rng.normal(size=(K, Np))) for _ in range(3)]
    f_r = react.react_combine_ref(*g, rblocks, route).numpy()
    for f in (react.react_combine_target_ref(*g, rtgt),
              react.react_combine(*g, rtgt)):
        assert rel_err(f.numpy(), f_r) <= 1e-12
