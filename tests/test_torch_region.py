"""Regions of the port (core/region.py) against the JAX package's
(float64, CPU): `inside` for Block, Prism, Sphere and the complement,
exact, on seeded random points; set_type_fraction(region=) against JAX in
float32 and float64; and the bounds reach the device once, so a repeated
call copies nothing from the host.
"""

import numpy as np
import pytest
import torch

from torch_parity import rel_err  # noqa: F401  (sets the thread count)

BIG = 1.0e30


def _regions(pkg):
    from importlib import import_module
    R = import_module(f"{pkg}.core.region")
    return {
        "block": R.Block(lo=(1.0, -2.0, 0.5), hi=(7.5, 4.0, 9.0)),
        "block_inf": R.Block(lo=(-BIG, 2.0, -BIG), hi=(BIG, 6.0, 3.0)),
        "prism": R.Prism(lo=(0.5, 1.0, -1.0), hi=(8.0, 7.0, 6.0),
                         tilt=(1.7, -0.9, 2.2)),
        "sphere": R.Sphere(center=(4.0, 3.0, 2.5), radius=3.3),
        "sphere_out": R.Sphere(center=(4.0, 3.0, 2.5),
                               radius=3.3).complement(),
        "prism_out": R.Prism(lo=(0.5, 1.0, -1.0), hi=(8.0, 7.0, 6.0),
                             tilt=(1.7, -0.9, 2.2)).complement(),
    }


def _points(n=4000, seed=11):
    return np.random.default_rng(seed).uniform(-2.0, 10.0, (n, 3))


@pytest.mark.parametrize("name", ["block", "block_inf", "prism", "sphere",
                                  "sphere_out", "prism_out"])
def test_inside_matches_jax_exactly(name):
    import jax.numpy as jnp
    x = _points()
    jin = np.asarray(_regions("lammps_plugins_tpu")[name].inside(
        jnp.asarray(x)))
    pin = _regions("lammps_plugins_tpu_torch")[name].inside(
        torch.as_tensor(x, dtype=torch.float64))
    assert pin.dtype == torch.bool and pin.shape == (len(x),)
    np.testing.assert_array_equal(pin.numpy(), jin)
    assert 0 < int(pin.sum()) < len(x)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_set_type_fraction_region_matches_jax(dtype):
    import jax.numpy as jnp
    from lammps_plugins_tpu.api.scenes import alsi_sample as jscene
    from lammps_plugins_tpu.fixes.velocity import set_type_fraction as jstf
    from lammps_plugins_tpu_torch.api.scenes import alsi_sample
    from lammps_plugins_tpu_torch.fixes.velocity import set_type_fraction
    jdt, pdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.float64, torch.float64))
    js = jscene(nc=8, dtype=jdt)
    ps = alsi_sample(nc=8, dtype=pdt, device="cpu")
    for name in ("prism", "sphere_out"):
        jt = np.asarray(jstf(js, 2, 0.4, 31,
                             region=_regions("lammps_plugins_tpu")[name]).type)
        pt = set_type_fraction(
            ps, 2, 0.4, 31,
            region=_regions("lammps_plugins_tpu_torch")[name]).type.numpy()
        np.testing.assert_array_equal(pt, jt)
        assert int((pt == 2).sum()) > int((ps.type == 2).sum())


def test_bounds_reach_the_device_once():
    """A second inside() makes no tensor from host data: the bounds (and
    the prism's inverse) are cached per dtype and device."""
    regions = _regions("lammps_plugins_tpu_torch")
    x = torch.as_tensor(_points(64), dtype=torch.float32)
    for r in regions.values():
        r.inside(x)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for name in ("tensor", "as_tensor"):
            real = getattr(torch, name)

            def spy(*a, _real=real, _name=name, **k):
                calls.append(_name)
                return _real(*a, **k)

            mp.setattr(torch, name, spy)
        for r in regions.values():
            r.inside(x)
    assert calls == []
