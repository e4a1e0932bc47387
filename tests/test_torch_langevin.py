"""fix langevin of the port against the JAX package's (CPU).

  * core/threefry.py draw for draw against jax.random: the key of
    PRNGKey(seed), fold_in(key, step) and uniform(key, (N, 3), dtype,
    -0.5, 0.5), bit for bit in float32 and float64, for seeds 1, 48279
    and 2^31 - 1, steps 0, 1 and 977 and N 1, 7 and 256;
  * FixLangevin.post_force against the JAX fix's compiled post_force
    (with and without a ramp, and with a group), bit for bit in float64;
  * the ramp window re-anchored by each `run` of the port's Script, the
    fix's device step count carried by the device loop (its eager
    iteration on the CPU equals the host loop bit for bit), and the
    bad-argument errors.
"""

import numpy as np
import pytest
import torch

from lammps_plugins_tpu_torch.core import threefry

SEEDS = (1, 48279, 2 ** 31 - 1)
STEPS = (0, 1, 977)
SIZES = (1, 7, 256)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform_draws_equal_jax_random(seed, dtype):
    import jax
    import jax.numpy as jnp
    for step in STEPS:
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed),
                                  jnp.asarray(step, jnp.int32))
        key = threefry.fold_in(threefry.prng_key(seed), torch.tensor(step))
        assert [int(k) for k in key] == [int(k) for k in np.asarray(jkey)]
        for n in SIZES:
            ref = np.asarray(jax.random.uniform(
                jkey, (n, 3), getattr(jnp, dtype), minval=-0.5, maxval=0.5))
            got = threefry.uniform(key, (n, 3), getattr(torch, dtype),
                                   -0.5, 0.5).numpy()
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got.view(np.uint8),
                                          ref.view(np.uint8))


def test_prng_key_and_raw_hash_equal_jax():
    import jax
    from jax._src import prng
    for seed in SEEDS:
        assert list(threefry.prng_key(seed)) == [
            int(k) for k in np.asarray(jax.random.PRNGKey(seed))]
    k = (0x13198A2E, 0x03707344)
    x = np.arange(10, dtype=np.uint32) * np.uint32(2654435761)
    ref = np.asarray(prng.threefry_2x32(np.asarray(k, np.uint32), x))
    half = len(x) // 2
    y0, y1 = threefry.threefry2x32(k[0], k[1],
                                   torch.as_tensor(x[:half], dtype=torch.int64),
                                   torch.as_tensor(x[half:], dtype=torch.int64))
    np.testing.assert_array_equal(torch.cat([y0, y1]).numpy(),
                                  ref.astype(np.int64))


def _fixes(t_stop, group):
    from lammps_plugins_tpu.fixes.langevin import FixLangevin as JL
    from lammps_plugins_tpu_torch.fixes.langevin import FixLangevin as PL
    gm = (np.arange(288) % 3 == 0) if group else None
    jf, pf = (cls(0.1, t_stop, 0.5, 48279, group_mask=gm)
              for cls in (JL, PL))
    for f in (jf, pf):
        f.begin_step, f.end_step = 0, 60
    return jf, pf


@pytest.mark.parametrize("variant", ["plain", "ramp", "group"])
def test_post_force_equals_jax(variant):
    """The port's post_force equals the JAX fix's eager post_force bit
    for bit, and its compiled one to rounding (XLA fuses the gamma
    products); the ramp's target equals the compiled step's bit for bit
    (a float32 product with the reciprocal of the window)."""
    import jax
    import jax.numpy as jnp
    from lammps_plugins_tpu.api.scenes import rebomos_bulk
    from lammps_plugins_tpu.core import units as ju
    from lammps_plugins_tpu.fixes.base import StepContext as JC
    from lammps_plugins_tpu_torch import convert
    from lammps_plugins_tpu_torch.core import units as pu
    from lammps_plugins_tpu_torch.fixes.base import StepContext as PC
    jf, pf = _fixes(1.5 if variant == "ramp" else 0.1, variant == "group")
    rng = np.random.default_rng(0)
    st = rebomos_bulk()
    st = st.replace(v=jnp.asarray(rng.normal(size=st.v.shape)),
                    f=jnp.asarray(rng.normal(size=st.v.shape)))
    jc, pc = JC(units=ju.METAL, dt=0.001), PC(units=pu.METAL, dt=0.001)
    post = jax.jit(lambda s: jf.post_force(s, jc).f)
    target = jax.jit(lambda s: jf._t_target(s))
    ps = pf.setup(convert.state_from_numpy(st), pc)
    for step in (0, 3, 17, 59, 60, 75):
        js = st.replace(step=jnp.asarray(step, jnp.int32))
        ps.extras[pf.key]["step"].fill_(step)
        got = pf.post_force(ps, pc).f.numpy()
        compiled = np.asarray(post(js))
        assert np.abs(got - compiled).max() <= 1e-15 * np.abs(compiled).max()
        if variant == "ramp":
            assert float(pf._t_target(ps)) == float(target(js))
        else:
            np.testing.assert_array_equal(
                got, np.asarray(jf.post_force(js, jc).f))


def _lj_script(extra, **kw):
    from lammps_plugins_tpu_torch.api.script import Script
    s = Script(log=lambda _: None, dtype=torch.float64, device="cpu")
    s.run_text("""
units           lj
atom_style      atomic
lattice         fcc 0.8442
region          box block 0 3 0 3 0 3
create_box      1 box
create_atoms    1 box
mass            1 1.0
pair_style      lj/cut 2.5
pair_coeff      1 1 1.0 1.0 2.5
neighbor        0.3 bin
fix             1 all nve
""" + extra)
    return s


def test_ramp_window_set_by_run():
    s = _lj_script("fix 2 all langevin 0.1 1.5 0.5 999\nrun 20\n")
    fx = s.fixes[-1]
    assert (fx.begin_step, fx.end_step) == (0, 20)
    assert int(s.engine.state.extras[fx.key]["step"]) == 20
    s.command("run 30")
    assert (fx.begin_step, fx.end_step) == (20, 50)
    assert int(s.engine.state.extras[fx.key]["step"]) == 50
    assert fx.capture_key() == (0.1, 1.5, 20, 50)


def test_device_loop_carries_the_noise_step():
    """The device loop's iteration (eager on the CPU) and the host loop
    give the same bits: the fix's step count travels with the state, so
    every step draws the noise of its own count."""
    out = []
    for fused in (True, False):
        s = _lj_script("velocity all create 1.0 87287\n"
                       "fix 2 all langevin 0.8 1.2 0.5 48279\nrun 0\n")
        s.engine.fused_loop = fused
        s.command("run 40")
        out.append(s.engine.state)
    a, b = out
    for f in ("x", "v", "f", "image"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    key = "langevin:2"
    assert int(a.extras[key]["step"]) == int(b.extras[key]["step"]) == 40


def test_bad_arguments_raise():
    from lammps_plugins_tpu_torch.api.script import ScriptError
    from lammps_plugins_tpu_torch.fixes.langevin import FixLangevin
    with pytest.raises(ValueError, match="damp"):
        FixLangevin(1.0, 1.0, -0.5, 1)
    with pytest.raises(ValueError, match="seed"):
        FixLangevin(1.0, 1.0, 0.5, 0)
    s = _lj_script("")
    with pytest.raises(ScriptError, match="langevin keywords"):
        s.command("fix 2 all langevin 300 300 0.1 48279 zero yes")
