"""Smallest-K selection of the port (ops/select_k.py) against the JAX
Pallas kernel select_k (interpret mode): positions exact, payloads exact
wherever a slot was found, exhausted slots W — with ties and empty rows.

The rebuild's fused candidate selection (ops/select_candidates.py, kernel
D'), whose twin builds the keys and selects: on the arguments the device
rebuild hands it (the jiggled 288-atom scene, float64 with the JAX plan
and float32 with the port's, each also with a fine-cell capacity of 4 that
overflows) the twin gives idx, jtype, mask and kmax equal to the unfused
code the rebuild ran before (kept below), and the rebuild's rows are the
JAX device_rebuild's rows as sets, with the same kmax and overflow flags.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lammps_plugins_tpu.ops.select_k_pallas import select_k as jax_select_k
from lammps_plugins_tpu_torch import convert
from lammps_plugins_tpu_torch.neighbor import device_build as pdb
from lammps_plugins_tpu_torch.ops import select_candidates as ops_sc
from lammps_plugins_tpu_torch.ops import select_k as ops_sk
from torch_parity import jax_engine, port_engine, rebuild_with_spy


def _keys(seed, ties, N=40, W=256):
    rng = np.random.default_rng(seed)
    keys = rng.uniform(0.0, 10.0, (N, W)).astype(np.float32)
    if ties:
        keys = np.round(keys * 2.0) / 2.0          # many exact ties
    mask = rng.uniform(size=(N, W)) < 0.6
    mask[0] = False                                # no valid slot
    mask[1, :5] = True                             # fewer than K valid
    mask[1, 5:] = False
    keys = np.where(mask, keys, np.inf).astype(np.float32)
    ids = rng.integers(0, 2 ** 20, (N, W)).astype(np.float32)
    types = rng.integers(1, 3, (N, W)).astype(np.float32)
    return keys, ids, types


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, True)])
def test_twin_matches_pallas_kernel(seed, ties):
    K = 16
    keys, ids, types = _keys(seed, ties)
    W = keys.shape[1]
    pos_j, ids_j, typ_j = (np.asarray(a) for a in jax_select_k(
        jnp.asarray(keys), K, interpret=True,
        payloads=(jnp.asarray(ids), jnp.asarray(types))))
    pos_p, ids_p, typ_p = (a.numpy() for a in ops_sk.select_k(
        torch.from_numpy(keys), K,
        payloads=(torch.from_numpy(ids), torch.from_numpy(types))))
    np.testing.assert_array_equal(pos_p, pos_j)
    found = pos_p < W
    np.testing.assert_array_equal(ids_p[found], ids_j[found])
    np.testing.assert_array_equal(typ_p[found], typ_j[found])
    assert (pos_p[0] == W).all() and (pos_p[1, 5:] == W).all()
    assert (ids_p[~found] == 0).all()


def test_twin_orders_ties_by_column():
    keys = torch.tensor([[3.0, 1.0, 1.0, float("inf"), 1.0, 0.5]])
    (pos,) = ops_sk.select_k(keys, 5)
    np.testing.assert_array_equal(pos.numpy(), [[5, 1, 2, 4, 0]])


def _unfused(xt_pad, dense_f, c3f, fdims, cm, skin, K):
    """The rebuild's candidate code before kernel D' (packed row gather,
    keys with the per-type-pair select chain, then select_k), one chunk."""
    n = c3f.shape[0]
    m_all = xt_pad.shape[0] - 1
    dtype = xt_pad.dtype
    as_t = lambda v: torch.as_tensor(np.asarray(v), dtype=dtype)  # noqa
    xw, types = xt_pad[:n, :3], xt_pad[:n, 3].long()
    Cf = dense_f.shape[1]
    ncf = fdims[0] * fdims[1] * fdims[2]
    offs27 = torch.tensor([(a, b, c) for a in (-1, 0, 1)
                           for b in (-1, 0, 1) for c in (-1, 0, 1)])
    nbr3 = c3f[:, None, :] + offs27[None, :, :]
    in_rng = torch.all((nbr3 >= 0) & (nbr3 < torch.tensor(fdims)), -1)
    ncid = (nbr3[..., 0] * fdims[1] + nbr3[..., 1]) * fdims[2] + nbr3[..., 2]
    ncid = torch.where(in_rng, ncid, torch.full_like(ncid, ncf + 1))
    W = 27 * Cf
    Wp = -(-W // 128) * 128
    tmp4 = xt_pad[dense_f]
    idf = torch.clamp(dense_f, max=m_all).to(dtype)
    packed5 = torch.cat([tmp4[..., 0], tmp4[..., 1], tmp4[..., 2],
                         tmp4[..., 3], idf], dim=1)
    g = packed5[ncid]
    comp = [g[:, :, a * Cf:(a + 1) * Cf].reshape(n, W) for a in range(5)]
    cand, cand_t = comp[4], comp[3]
    rsq = torch.zeros_like(cand)
    for a in range(3):
        da = comp[a] - xw[:, a][:, None]
        rsq = rsq + da * da
    rid = torch.arange(n).to(dtype)
    valid = (cand < m_all) & (cand != rid[:, None])
    ti = types[:, None]
    T = cm.shape[0] - 1
    cut = torch.zeros_like(cand)
    for a in range(1, T + 1):
        row = torch.zeros_like(cand)
        for b in range(1, T + 1):
            row = torch.where(cand_t == b, as_t(cm[a, b]), row)
        cut = torch.where(ti == a, row, cut)
    cut = cut + skin
    m_tier = valid & (rsq < cut * cut)
    key = torch.where(m_tier, rsq, torch.full_like(rsq, float("inf")))
    padw = lambda a_, fill: torch.nn.functional.pad(  # noqa: E731
        a_, (0, Wp - W), value=fill)
    pos, idfk, jtfk = ops_sk.select_k_ref(
        padw(key, float("inf")), K,
        payloads=(padw(cand, 0.0), padw(cand_t, 0.0)))
    mask = pos < W
    zero = torch.zeros((), dtype=torch.int64)
    return (torch.where(mask, idfk.to(torch.int64), zero),
            torch.where(mask, jtfk.to(torch.int64), zero), mask,
            m_tier.sum(dim=1).max())


@pytest.fixture(scope="module", params=["fits", "overflows"])
def rebuilt(request):
    """JAX and port device rebuilds of the jiggled 288-atom scene (f64) on
    one plan; "overflows" cuts the fine cells to 4 slots."""
    from lammps_plugins_tpu.neighbor import device_build as jdb
    jeng = jax_engine("bulk", "f64", jiggle=0.05)
    js = jeng.state
    h, h_inv, lo = jeng._box_dev
    plan = jeng._plan
    if request.param == "overflows":
        plan = dataclasses.replace(plan, cand_capacity=4)
    requests = jeng.pair.neighbor_requests()
    _, _, jnbr, jflags = jdb.device_rebuild(
        plan, js.x, js.image, js.type, h, h_inv, lo, jeng._cut_mats_dev)
    ps = convert.state_from_numpy(js)
    as_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    pplan = convert.plan_from_fields(plan)
    (_, _, pnbr, pflags), calls = rebuild_with_spy(
        pplan, ps.x, ps.image, ps.type, as_t(h), as_t(h_inv), as_t(lo),
        requests)
    assert bool(pflags["candcell_overflow"]) == (request.param == "overflows")
    return (jnbr, {k: int(v) for k, v in jflags.items()}, pnbr,
            pdb.flags_to_host(pflags), calls, requests, pplan.skin)


def test_candidate_twin_equals_unfused_code(rebuilt):
    *_, calls, requests, skin = rebuilt
    assert len(calls) == 1
    args, (idx, jtype, mask, kmax) = calls[0]
    xt_pad, dense_f, c3f, fdims, cut, K = args[:6]
    ref = _unfused(xt_pad, dense_f, c3f, fdims,
                   np.asarray(requests["rebo"], np.float64), skin, K)
    for a, b, c in zip((idx, jtype, mask), ref[:3],
                       ops_sc.select_candidates_ref(*args)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert int(kmax) == int(ref[3]) > 0


def test_candidate_rows_match_jax_rebuild(rebuilt):
    jnbr, jflags, pnbr, pflags, *_ = rebuilt
    for key in ("count:k:rebo", "k_overflow:rebo", "candcell_overflow",
                "count:candcell"):
        assert pflags[key] == jflags[key]
    jl, pl = jnbr.lists["rebo"], pnbr.lists["rebo"]
    jidx, jm = np.asarray(jl.idx), np.asarray(jl.mask)
    pidx, pm = pl.idx.numpy(), pl.mask.numpy()
    for i in range(jidx.shape[0]):
        assert sorted(pidx[i][pm[i]]) == sorted(jidx[i][jm[i]])
    np.testing.assert_array_equal(pl.jtype.numpy()[pm],
                                  np.asarray(jl.jtype)[jm])


@pytest.mark.parametrize("cand_capacity", [None, 4])
def test_candidate_twin_equals_unfused_code_f32(cand_capacity):
    """The port's own float32 plan and rebuild (and one whose fine cells
    overflow): the twin and the unfused code agree element for element."""
    eng = port_engine("bulk", dtype=torch.float32, jiggle=0.05)
    eng.rebuild_neighbors()
    plan = eng._plan
    if cand_capacity:
        plan = dataclasses.replace(plan, cand_capacity=cand_capacity)
    st = eng.state
    h, h_inv, lo = eng._box_dev
    requests = eng.pair.neighbor_requests()
    (_, _, _, flags), calls = rebuild_with_spy(
        plan, st.x, st.image, st.type, h, h_inv, lo, requests)
    assert bool(flags["candcell_overflow"]) == bool(cand_capacity)
    (xt_pad, dense_f, c3f, fdims, cut, K, _), out = calls[0]
    assert xt_pad.dtype == torch.float32
    ref = _unfused(xt_pad, dense_f, c3f, fdims,
                   np.asarray(requests["rebo"], np.float64), plan.skin, K)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    # every owned atom has its row, in the table or not
    assert out[2].any(dim=1).all()
