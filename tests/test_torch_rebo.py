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
