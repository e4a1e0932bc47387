"""Smallest-K selection of the port (ops/select_k.py) against the JAX
Pallas kernel select_k (interpret mode): positions exact, payloads exact
wherever a slot was found, exhausted slots W — with ties and empty rows.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lammps_plugins_tpu.ops.select_k_pallas import select_k as jax_select_k
from lammps_plugins_tpu_torch.ops import select_k as ops_sk


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
