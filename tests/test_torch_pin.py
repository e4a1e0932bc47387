"""Layout-pin copy of the port (ops/pin.py) against the JAX package, and the
`pin` / `pin2` force configurations.

The twins against pin_rows3, pin_rows3_v2 and the standalone _pin_call of
lammps_plugins_tpu/ops/pin_rows.py (interpret mode) on the same numpy
data: exact, shapes included.  REBOMoS.forces with combine="pin" and
"pin2" against the default configuration on the same lists (float64,
1e-10 relative), and 20 NVE steps against the default trajectory (1e-9).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lammps_plugins_tpu_torch.ops import pin
from torch_parity import (assert_same_trajectory, config_forces_rel_err,
                          run_20_steps)

K, NP = 16, 384          # the [K, Np] plane shape of the 288-atom scene


@pytest.fixture(scope="module")
def stacked():
    rng = np.random.default_rng(9)
    return rng.normal(size=(K, NP, 3)).astype(np.float32)


@pytest.mark.parametrize("name", ["pin_rows3", "pin_rows3_v2"])
def test_pin_rows_match_jax(stacked, name):
    from lammps_plugins_tpu.ops import pin_rows
    out_j = np.asarray(getattr(pin_rows, name)(jnp.asarray(stacked),
                                               interpret=True))
    out_p = getattr(pin, name)(torch.from_numpy(stacked)).numpy()
    assert out_p.shape == out_j.shape == (K * NP, 3)
    np.testing.assert_array_equal(out_p, out_j)


@pytest.mark.parametrize("wr", [64, 128])
def test_pin_copy_matches_pin_call(wr):
    """The standalone [Np, Wr] copy of the row-fetch table."""
    from lammps_plugins_tpu.ops.pin_rows import _pin_call
    a = np.random.default_rng(wr).normal(size=(NP, wr)).astype(np.float32)
    out_j = np.asarray(_pin_call(jnp.asarray(a), interpret=True))
    t = torch.from_numpy(a)
    out_p = pin.pin_copy(t)
    assert out_p.data_ptr() != t.data_ptr()
    np.testing.assert_array_equal(out_p.numpy(), out_j)


@pytest.mark.parametrize("combine", ["pin", "pin2"])
def test_forces_match_default_configuration(combine):
    assert config_forces_rel_err(dict(combine=combine), "bulk") <= 1e-10


@pytest.fixture(scope="module")
def default_run():
    return run_20_steps()


@pytest.mark.parametrize("combine", ["pin", "pin2"])
def test_20_steps_match_default_trajectory(default_run, combine):
    assert_same_trajectory(run_20_steps(combine=combine), default_run)
