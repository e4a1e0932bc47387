"""REBO cotangents of the port (ops/rebo.py) against the JAX package.

The twin (autograd of the port's REBO energy) is held against the JAX
Pallas kernel in interpret mode at the JAX suite's f32 bar (5e-4 x scale),
and against the JAX autodiff cotangents in float64 to rounding, with the
synthetic parameters and again with degree-6 g and gamma polynomials
(`sextic_tables`).  The CUDA kernel is held against the twin in
tests/test_torch_cuda.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lammps_plugins_tpu_torch.ops import rebo as ops_rebo
from torch_parity import jax_engine, port_of, rel_err, sextic_tables


def _planes(pair, st, nbr):
    return pair._rebo_planes(st.x, pair.el_of_type[st.type], nbr.ghosts,
                             nbr.lists["rebo"], st.box.h)


@pytest.fixture(scope="module")
def f32_setup():
    jeng = jax_engine("small", "f32", jiggle=0.12)
    pair, st, nbr = port_of(jeng, torch.float32)
    return jeng, pair, _planes(pair, st, nbr)


def _pallas_vs_twin(planes, jax_consts, port_consts):
    from lammps_plugins_tpu.ops.rebo_pallas import _rebo_call
    dxT, dyT, dzT, jelT, mskT, ei = (p.numpy() for p in planes)
    eiT = np.zeros((8, ei.shape[0]), np.float32)
    eiT[0] = ei
    g_jax = _rebo_call(*(jnp.asarray(a) for a in
                         (dxT, dyT, dzT, jelT, mskT, eiT)),
                       consts_key=tuple(sorted(jax_consts.items())),
                       interpret=True)
    g_port = ops_rebo.rebo_cotangents(*planes, port_consts)
    scale = max(np.abs(np.asarray(g)).max() for g in g_jax)
    assert scale > 1e-3
    for gp, gj in zip(g_port, g_jax):
        np.testing.assert_allclose(gp.numpy(), np.asarray(gj),
                                   atol=5e-4 * scale, rtol=5e-4)


def test_twin_matches_pallas_kernel_f32(f32_setup):
    jeng, pair, planes = f32_setup
    _pallas_vs_twin(planes, jeng.pair._rebo_consts, pair._rebo_consts)


def test_twin_matches_pallas_kernel_f32_sextic(f32_setup):
    """Every b2..b6 and bg2..bg6 slot non-zero (the file's are 0)."""
    from lammps_plugins_tpu.ops.rebo_pallas import derive_rebo_constants
    _, _, planes = f32_setup
    t = sextic_tables()
    _pallas_vs_twin(planes, derive_rebo_constants(t),
                    ops_rebo.derive_rebo_constants(t))


def _autodiff_vs_twin(tables=None):
    """f64: the twin against jax.vjp of the JAX _rebo_energy_core."""
    from lammps_plugins_tpu.potentials.rebomos import REBOMoS as JREBO
    from lammps_plugins_tpu_torch import convert
    jeng = jax_engine("bulk", "f64", jiggle=0.05)
    jp, js, nbr = jeng.pair, jeng.state, jeng.nbr
    pair, st, pn = port_of(jeng)
    if tables is not None:
        jp = JREBO(tables, jp.typemap_np, dtype=jnp.float64)
        pair = convert.rebomos_from_tables(tables, jp.typemap_np)
    rebo = nbr.lists["rebo"]
    el_own = jp.typemap[js.type]
    el_all = jp.typemap[nbr.ghosts.all_types(js.type)]
    x_all = nbr.ghosts.all_positions(js.x, js.box.h)
    D = x_all[rebo.idx]
    d = [D[..., a] - js.x[:, a][:, None] for a in range(3)]

    def e_of_d(dx, dy, dz):
        rsq = jnp.where(rebo.mask, dx * dx + dy * dy + dz * dz, 1.0)
        return jp._rebo_energy_core(dx, dy, dz, rsq, rebo.mask, rebo,
                                    el_own, el_all)

    _, vjp = jax.vjp(e_of_d, *d)
    g_jax = [np.asarray(g) for g in vjp(jnp.ones((), jnp.float64))]
    g_port = ops_rebo.rebo_cotangents(*_planes(pair, st, pn),
                                      pair._rebo_consts)
    n = st.natoms
    assert max(np.abs(g).max() for g in g_jax) > 1e-3
    for gp, gj in zip(g_port, g_jax):
        assert rel_err(gp[:, :n].t().numpy(), gj) < 1e-9


def test_twin_matches_jax_autodiff_f64():
    _autodiff_vs_twin()


def test_twin_matches_jax_autodiff_f64_sextic():
    _autodiff_vs_twin(sextic_tables())


def test_cpu_dispatch_takes_twin_and_counts_nothing(f32_setup):
    _, pair, planes = f32_setup
    before = ops_rebo.launches
    out = ops_rebo.rebo_cotangents(*planes, pair._rebo_consts)
    assert ops_rebo.launches == before
    assert all(o.device.type == "cpu" for o in out)


def test_constant_vector_layout(f32_setup):
    """64 floats: 7 bilinear pair rows, then 18 linear center rows."""
    _, pair, _ = f32_setup
    vec = ops_rebo.rebo_constant_vector(pair._rebo_consts)
    assert len(vec) == 64
    assert tuple(vec[0:4]) == pair._rebo_consts["pair:rcmin"]
    assert tuple(vec[28:30]) == pair._rebo_consts["ctr:b0"]
    assert tuple(vec[-2:]) == pair._rebo_consts["ctr:a3"]


@pytest.mark.parametrize("sextic", [False, True])
def test_dead_slots_add_nothing_f64(sextic):
    """The premise of the CUDA kernel's compaction, in float64: the
    288-atom scene's REBO planes, K 16 -> 24 with four masked slots and
    four unmasked slots past rcmax added to every atom.  The G of the
    original slots is unchanged, every added slot's G is exactly 0 in the
    port, and the port's G matches the JAX package's autodiff G."""
    from lammps_plugins_tpu_torch import convert
    jeng = jax_engine("bulk", "f64", jiggle=0.05)
    jp = jeng.pair
    pair, st, pn = port_of(jeng)
    if sextic:
        t = sextic_tables()
        jp = type(jp)(t, jp.typemap_np, dtype=jnp.float64)
        pair = convert.rebomos_from_tables(t, jp.typemap_np)
    planes = _planes(pair, st, pn)
    K, Np = planes[0].shape
    n = st.natoms
    rng = np.random.default_rng(11)
    ej = rng.integers(0, 2, (8, Np)).astype(np.float64)
    ei = planes[5].numpy()
    u = rng.normal(size=(3, 8, Np))
    u /= np.linalg.norm(u, axis=0)
    rcmax = pair.tables.rcmax[ei.astype(int)[None, :], ej.astype(int)]
    r = rcmax + rng.uniform(0.01, 1.0, (8, Np))
    d = u * r
    d[:, :4] = rng.uniform(-3.0, 3.0, (3, 4, Np))     # masked: any value
    msk = np.ones((8, Np))
    msk[:4] = 0.0
    extra = [torch.as_tensor(a) for a in (d[0], d[1], d[2], ej, msk)]
    padded = [torch.cat([p, e]) for p, e in zip(planes[:5], extra)]
    padded.append(planes[5])
    assert padded[0].shape == (K + 8, Np)

    g0 = ops_rebo.rebo_cotangents(*planes, pair._rebo_consts)
    g1 = ops_rebo.rebo_cotangents(*padded, pair._rebo_consts)
    for a, b in zip(g0, g1):
        assert rel_err(b[:K].numpy(), a.numpy()) <= 1e-12
        assert not bool(b[K:].any())

    def e_of_d(dx, dy, dz):
        mask = jnp.asarray(padded[4][:, :n].T.numpy() > 0)
        rsq = jnp.where(mask, dx * dx + dy * dy + dz * dz, 1.0)
        eI = jnp.broadcast_to(jnp.asarray(ei[:n].astype(np.int32))[:, None],
                              mask.shape)
        eJ = jnp.asarray(padded[3][:, :n].T.numpy().astype(np.int32))
        return jp._rebo_energy_rows(dx, dy, dz, rsq, mask, eI, eJ)

    dd = [jnp.asarray(p[:, :n].T.numpy()) for p in padded[:3]]
    _, vjp = jax.vjp(e_of_d, *dd)
    g_jax = vjp(jnp.ones((), jnp.float64))
    for gp, gj in zip(g1, g_jax):
        assert rel_err(gp[:, :n].t().numpy(), np.asarray(gj)) <= 1e-9


@pytest.mark.parametrize("K", [8, 36, 64])
def test_twin_is_zero_on_dead_slots_of_synthetic_planes(K):
    """The planes the card tests feed the kernel: atoms without a live
    edge, masked-in slots past rcmax and (K > 32) atoms with more than 32
    live edges; the twin's G is finite and exactly 0 on every dead slot."""
    from torch_parity import synthetic_rebo_planes
    planes, dead = synthetic_rebo_planes(K, 8 * 37 + 3, seed=K)
    consts = ops_rebo.derive_rebo_constants(sextic_tables())
    g = ops_rebo.rebo_cotangents(*[p.double() for p in planes], consts)
    live = (~dead).sum(dim=0)
    assert int((live == 0).sum()) > 0
    if K > 32:
        assert int((live > 32).sum()) >= 8
    for a in g:
        assert bool(torch.isfinite(a).all())
        assert not bool(a[dead].any())
    assert max(float(a.abs().max()) for a in g) > 1e-3
