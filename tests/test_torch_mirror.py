"""Mirror combine of the port (ops/mirror.py) against both JAX forms.

Given the same REBO cotangent planes G (the JAX Pallas kernel's output,
interpret mode), the port's twin must give the per-atom REBO forces of
the JAX row-fetch combine (mirror_combine_rowfetch behind the _pin_call
layout pin) and of the element-gather fallback (LPT_MIR=elem), at the
1e-5 x scale bar (f32 sums in another order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lammps_plugins_tpu_torch.ops import mirror as ops_mirror
from torch_parity import jax_engine, port_of


@pytest.fixture(scope="module")
def setup():
    from lammps_plugins_tpu.ops.rebo_pallas import _rebo_call
    jeng = jax_engine("small", "f32", jiggle=0.12)
    pair, st, nbr = port_of(jeng, torch.float32)
    planes = pair._rebo_planes(st.x, pair.el_of_type[st.type], nbr.ghosts,
                               nbr.lists["rebo"], st.box.h)
    eiT = np.zeros((8, planes[5].shape[0]), np.float32)
    eiT[0] = planes[5].numpy()
    consts_key = tuple(sorted(jeng.pair._rebo_consts.items()))
    g = _rebo_call(*(jnp.asarray(p.numpy()) for p in planes[:5]),
                   jnp.asarray(eiT), consts_key=consts_key, interpret=True)
    rl = nbr.lists["rebo"]
    f_port = ops_mirror.mirror_combine(
        *(torch.from_numpy(np.array(a)) for a in g), rl.mirT,
        rl.mirvT.float())[:st.natoms].numpy()
    return jeng, g, f_port


def _jax_rebo_forces(jeng):
    jp, js, nbr = jeng.pair, jeng.state, jeng.nbr
    return np.asarray(jp._rebo_forces_mirror_tn(
        js.x, jp.typemap[js.type],
        jp.typemap[nbr.ghosts.all_types(js.type)], nbr.ghosts,
        nbr.lists["rebo"], js.box.h, interpret=True))


def test_matches_rowfetch_combine(setup):
    """The row-fetch form, rebuilt step by step as rebomos.py:595-606."""
    from lammps_plugins_tpu.ops.mirror_pallas import mirror_combine_rowfetch
    from lammps_plugins_tpu.ops.pin_rows import _pin_call
    jeng, (gx, gy, gz), f_port = setup
    rebo = jeng.nbr.lists["rebo"]
    K, Np = gx.shape
    Wr = 64 if 3 * K <= 64 else 128
    stacked = jnp.concatenate([gx, gy, gz,
                               jnp.zeros((Wr - 3 * K, Np), gx.dtype)])
    grow = _pin_call(jnp.swapaxes(stacked, 0, 1), interpret=True)
    rows2 = grow[(rebo.mirT % Np).reshape(-1)].reshape(K, Np, Wr)
    F8 = mirror_combine_rowfetch(gx, gy, gz, rows2,
                                 (rebo.mirT // Np).astype(gx.dtype),
                                 rebo.mirvT.astype(gx.dtype),
                                 interpret=True)
    f_jax = np.asarray(F8[:3]).T[:f_port.shape[0]]
    scale = np.abs(f_jax).max()
    assert scale > 1e-3
    np.testing.assert_allclose(f_port, f_jax, atol=1e-5 * scale, rtol=0)


def test_matches_default_dispatch_rowfetch(setup):
    """JAX's default dispatch takes the row-fetch form at this size."""
    jeng, _, f_port = setup
    f_jax = _jax_rebo_forces(jeng)
    np.testing.assert_allclose(f_port, f_jax,
                               atol=1e-5 * np.abs(f_jax).max(), rtol=0)


def test_matches_element_gather_fallback(setup, monkeypatch):
    jeng, _, f_port = setup
    monkeypatch.setenv("LPT_MIR", "elem")
    f_jax = _jax_rebo_forces(jeng)
    np.testing.assert_allclose(f_port, f_jax,
                               atol=1e-5 * np.abs(f_jax).max(), rtol=0)


def test_nk_form_matches_planes_form(setup):
    """neighbor.mirror_combine over [N, K] cotangents and the flat
    row*K + col mirror table gives the planes form's forces."""
    from lammps_plugins_tpu_torch import convert
    from lammps_plugins_tpu_torch.neighbor.neighbor import mirror_combine
    jeng, g, f_port = setup
    rl = convert.neighbor_data_from_numpy(jeng.nbr,
                                          dtype=torch.float32).lists["rebo"]
    n = f_port.shape[0]
    gnk = [torch.from_numpy(np.array(a)).t()[:n].contiguous() for a in g]
    f_nk = mirror_combine(*gnk, rl).numpy()
    np.testing.assert_allclose(f_nk, f_port,
                               atol=1e-5 * np.abs(f_port).max(), rtol=0)


def test_mirror_is_an_involution(setup):
    """mirT maps every valid edge to an edge whose mirror is itself."""
    jeng, _, _ = setup
    from lammps_plugins_tpu_torch import convert
    rl = convert.neighbor_data_from_numpy(jeng.nbr).lists["rebo"]
    mir, ok = rl.mirT.long().reshape(-1), rl.mirvT.reshape(-1)
    assert ok.any()
    back = mir[mir[ok]]
    np.testing.assert_array_equal(back.numpy(),
                                  torch.nonzero(ok)[:, 0].numpy())
