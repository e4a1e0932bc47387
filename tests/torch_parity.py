"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_*.py).

Scenes are built by both packages from the same arguments; the JAX side
runs on the CPU (its Pallas kernels in interpret mode), and data crosses
between the packages as numpy arrays.  Whether a CUDA device exists is
decided inside the `cuda` fixture, never at import time.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SYNTH_REBO = os.path.join(DATA, "MoS.REBO.synthetic")
SYNTH_AEAM = os.path.join(DATA, "AlSi.synthetic.aeam")
SYNTH_AEAM_ASYM = os.path.join(DATA, "AlSi.synthetic.asym.aeam")

# The suite runs in several worker processes that share the machine's
# cores; torch's default of one thread per core in every worker
# oversubscribes them many times over and slows these tests ~10x.
torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def jax_engine(scene="bulk", dtype="f64", jiggle=0.0, seed=4, **kw):
    """A JAX-package Engine after one device rebuild.

    scene 'bulk' is the 288-atom in.rebomos-bulk cell, 'small' the
    72-atom rebomos_bulk_commensurate(3, 4, 1); jiggle displaces every
    atom uniformly in [-jiggle, jiggle] (numpy seed) so that forces are
    non-trivial."""
    import jax.numpy as jnp
    from lammps_plugins_tpu.api.scenes import (rebomos_bulk,
                                               rebomos_bulk_commensurate)
    from lammps_plugins_tpu.core import units
    from lammps_plugins_tpu.fixes.nve import FixNVE
    from lammps_plugins_tpu.potentials.rebomos import REBOMoS
    from lammps_plugins_tpu.run.simulation import Engine

    jdt = jnp.float32 if dtype == "f32" else jnp.float64
    state = (rebomos_bulk(dtype=jdt) if scene == "bulk"
             else rebomos_bulk_commensurate(nx=3, ny=4, nz=1, dtype=jdt))
    if jiggle:
        rng = np.random.default_rng(seed)
        x = np.asarray(state.x) + rng.uniform(-jiggle, jiggle,
                                              state.x.shape)
        state = state.replace(x=jnp.asarray(x, jdt))
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], dtype=jdt)
    eng = Engine(state, pair, [FixNVE()], units.METAL, device_rebuild=True,
                 **kw)
    eng.rebuild_neighbors()
    return eng


def port_engine(scene="small", dtype=torch.float64, jiggle=0.12, seed=4,
                **config):
    """A port Engine on the CPU: the scene of jax_engine, jiggled the same
    way, with 300 K velocities (seed 12345) so that a run moves, and
    REBOMoS built with the force configuration `config`."""
    from lammps_plugins_tpu_torch.api.scenes import (
        rebomos_bulk, rebomos_bulk_commensurate)
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.fixes.velocity import velocity_create
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    from lammps_plugins_tpu_torch.run.simulation import Engine
    st = (rebomos_bulk(dtype=dtype, device="cpu") if scene == "bulk"
          else rebomos_bulk_commensurate(3, 4, 1, dtype=dtype,
                                         device="cpu"))
    if jiggle:
        rng = np.random.default_rng(seed)
        x = st.x.numpy() + rng.uniform(-jiggle, jiggle, st.x.shape)
        st = st.replace(x=torch.as_tensor(x, dtype=dtype))
    st = velocity_create(st, units.METAL, 300.0, 12345)
    pair = REBOMoS.from_file(SYNTH_REBO, ["M", "S"], dtype=dtype,
                             device="cpu", **config)
    return Engine(st, pair, [FixNVE()], units.METAL)


def config_forces_rel_err(config, scene="small", dtype=torch.float64):
    """max |F_config - F_default| / max |F_default| of REBOMoS.forces on
    the same state and lists."""
    from lammps_plugins_tpu_torch.potentials.rebomos import REBOMoS
    eng = port_engine(scene, dtype=dtype, **config)
    eng.rebuild_neighbors()
    st = eng.state
    default = REBOMoS(eng.pair.tables, eng.pair.typemap_np, dtype=dtype,
                      device="cpu")
    f_cfg = eng.pair.forces(st.x, st.type, eng.nbr, st.box.h)
    f_def = default.forces(st.x, st.type, eng.nbr, st.box.h)
    assert float(f_def.abs().max()) > 1e-3
    return rel_err(f_cfg.numpy(), f_def.numpy())


def run_20_steps(**config):
    """(x, v) after 20 NVE steps of the jiggled 72-atom scene (float64)
    under the force configuration `config` (no thermo rows: each costs
    seconds of autograd on the CPU)."""
    eng = port_engine("small", **config)
    eng.run(20)
    return eng.state.x.numpy(), eng.state.v.numpy()


def assert_same_trajectory(run, ref, tol=1e-9):
    """Two run_20_steps results agree to `tol` relative to their scale."""
    assert rel_err(run[0], ref[0]) <= tol
    assert rel_err(run[1], ref[1]) <= tol


def port_of(jeng, dtype=torch.float64):
    """(pair, state, nbr) of the port holding the JAX engine's data."""
    from lammps_plugins_tpu_torch import convert
    pair = convert.rebomos_from_tables(jeng.pair.tables,
                                       jeng.pair.typemap_np, dtype=dtype)
    return (pair, convert.state_from_numpy(jeng.state, dtype=dtype),
            convert.neighbor_data_from_numpy(jeng.nbr, dtype=dtype))


def sextic_tables():
    """The synthetic tables with non-zero b2..b6 and bg2..bg6 (distinct per
    element), so that every slot of the degree-6 g and gamma polynomials
    and their derivatives is exercised; the file's own are linear."""
    from lammps_plugins_tpu_torch.potentials.tables import read_rebomos
    t = read_rebomos(SYNTH_REBO)
    b, bg = t.b.copy(), t.bg.copy()
    b[:, 2:] = [[0.031, -0.022, 0.017, -0.012, 0.007],
                [0.027, -0.019, 0.013, -0.009, 0.005]]
    bg[:, 2:] = [[0.041, -0.033, 0.024, -0.016, 0.008],
                 [0.036, -0.028, 0.021, -0.014, 0.006]]
    return dataclasses.replace(t, b=b, bg=bg)


def rebuild_with_spy(plan, x, image, types, h, h_inv, lo, requests, **kw):
    """The port's device_rebuild (kw: its options, e.g. valid=),
    recording the arguments and results of each select_candidates call:
    (rebuild output, [(args, result)])."""
    from lammps_plugins_tpu_torch.neighbor import device_build as pdb
    calls = []
    real = pdb.select_candidates

    def spy(*args):
        out = real(*args)
        calls.append((args, out))
        return out

    pdb.select_candidates = spy
    try:
        out = pdb.device_rebuild(plan, x, image, types, h, h_inv, lo,
                                 requests, **kw)
    finally:
        pdb.select_candidates = real
    return out, calls


def rel_err(a, b):
    """max |a - b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def synthetic_rebo_planes(K, Np, seed=0, dense=8):
    """[K, Np] REBO kernel inputs (dxT, dyT, dzT, jelT, mskT, ei; float32,
    CPU) that cover every kind of atom the kernel meets, and the [K, Np]
    bool of slots whose G must be exactly 0 (masked, or past rcmax).

    Atoms cycle through: no masked-in slot; 1..K masked-in slots at random
    positions with r in [2.0, 4.3] A (inside rcmin, in the switch, past
    rcmax of the synthetic parameters); masked-in slots all past rcmax; and
    (`dense` atoms, when K > 32) all K slots inside rcmin, so n = K > 32.
    Masked-out slots hold random displacements that must be ignored."""
    from lammps_plugins_tpu_torch.potentials.tables import read_rebomos
    t = read_rebomos(SYNTH_REBO)
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, 2, Np)
    ej = rng.integers(0, 2, (K, Np))
    u = rng.normal(size=(3, K, Np))
    u /= np.linalg.norm(u, axis=0)
    r = rng.uniform(2.0, 4.3, (K, Np))
    msk = np.zeros((K, Np), bool)
    for i in range(Np):
        kind = i % 4
        if kind == 1:
            m = rng.integers(1, K + 1)
            msk[rng.choice(K, m, replace=False), i] = True
        elif kind == 2:
            msk[:, i] = True
            r[:, i] = rng.uniform(3.9, 4.5, K)
    if K > 32:
        for i in range(3, 4 * dense, 4):
            msk[:, i] = True
            r[:, i] = rng.uniform(2.0, 2.25, K)
    d = u * r
    d[:, ~msk] = rng.uniform(-5.0, 5.0, (3, int((~msk).sum())))
    rcmax = t.rcmax[ei[None, :], ej]
    dead = ~msk | (r >= rcmax + 1e-3)
    as32 = lambda a: torch.as_tensor(np.ascontiguousarray(a),  # noqa: E731
                                     dtype=torch.float32)
    planes = [as32(d[0]), as32(d[1]), as32(d[2]), as32(ej), as32(msk),
              as32(ei)]
    return planes, torch.as_tensor(dead)


def synthetic_lj_planes(dims=(5, 5, 5), C=104, occ=None, cell=11.0,
                        order="sorted", empty=(), seed=0,
                        dtype=torch.float32):
    """LJ cell planes [Dx, Dy, Dz, 8, C] (rows x, y, z, element, owned)
    of random atoms, the LJ constants of the synthetic parameters, and
    a_range (every cell but the halo ring).

    Cell (i, j, k) spans [i, i + 1) x ... in units of `cell` Angstrom and
    holds occ[i, j, k] atoms (default: uniform in [0, C]) at uniform
    random positions, elements 0/1 at random; cells listed in `empty`
    hold none.  Atoms of a_range cells are owned.  Slot order within a
    cell: "sorted" by sub-cell on a 4 x 4 x 4 grid (compact runs of
    slots, as the device rebuild orders them), "random" (atoms and pads
    interleaved at random), or "index" (atoms first, in creation order);
    unused slots are pads parked at 1e7."""
    from lammps_plugins_tpu_torch.ops.lj_cells import derive_lj_constants
    from lammps_plugins_tpu_torch.potentials.tables import read_rebomos
    rng = np.random.default_rng(seed)
    Dx, Dy, Dz = dims
    if occ is None:
        occ = rng.integers(0, C + 1, dims)
    occ = np.minimum(np.broadcast_to(occ, dims), C).copy()
    for c in empty:
        occ[c] = 0
    P = np.zeros((Dx, Dy, Dz, 8, C))
    P[..., 0:3, :] = 1e7
    for i, j, k in np.ndindex(*dims):
        n = int(occ[i, j, k])
        u = rng.uniform(0.0, 1.0, (n, 3))
        if order == "sorted":
            s = np.floor(u * 4).astype(int)
            u = u[np.lexsort((s[:, 2], s[:, 1], s[:, 0]))]
        slots = (rng.permutation(C)[:n] if order == "random"
                 else np.arange(n))
        P[i, j, k, 0:3, slots] = (u + [i, j, k]) * cell
        P[i, j, k, 3, slots] = rng.integers(0, 2, n)
        inner = (0 < i < Dx - 1) and (0 < j < Dy - 1) and (0 < k < Dz - 1)
        P[i, j, k, 4, slots] = float(inner)
    consts = derive_lj_constants(read_rebomos(SYNTH_REBO))
    a_range = ((1, Dx - 1), (1, Dy - 1), (1, Dz - 1))
    return torch.as_tensor(P, dtype=dtype), consts, a_range


def permute_cell_slots(P, seed=0):
    """P with the slots of every cell permuted at random, and the
    [Dx, Dy, Dz, C] permutation: out[..., s] = P[..., perm[..., s]]."""
    g = torch.Generator().manual_seed(seed)
    perm = torch.argsort(torch.rand(P.shape[:3] + P.shape[-1:], generator=g),
                         dim=-1)
    return torch.gather(P, -1, perm[..., None, :].expand(P.shape)), perm


def mixture_arrays(ntypes, n=5, seed=21, jiggle=0.08):
    """A jiggled fcc lattice of 4 n^3 atoms at the LJ melt's density with
    ntypes atom types at random (numpy seed), and lj/cut coefficients
    (i, j, eps, sigma, cut) for every type pair, cuts in [2.0, 3.0]:
    (x, types, box length, coefficients)."""
    rng = np.random.default_rng(seed)
    a = (4.0 / 0.8442) ** (1.0 / 3.0)
    base = a * np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                         [0, 0.5, 0.5]])
    cells = a * np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"),
                         -1).reshape(-1, 3)
    x = (cells[:, None, :] + base[None]).reshape(-1, 3)
    x = x + rng.uniform(-jiggle, jiggle, x.shape)
    types = rng.integers(1, ntypes + 1, len(x))
    coeffs = [(i, j, rng.uniform(0.5, 1.5), rng.uniform(0.8, 1.2),
               rng.uniform(2.0, 3.0))
              for i in range(1, ntypes + 1) for j in range(i, ntypes + 1)]
    return x, types, n * a, coeffs


def ljcut_scene(kind, n, dtype=torch.float64, device="cpu", jiggle=0.05,
                seed=5):
    """An Engine (lists not yet built) of one lj/cut scene of kernel I's
    checks (ops/ljcut.py): "lj" lj_melt(n) (lj/cut 2.5); "charged"
    charged_melt(n) (lj/cut/coul/cut 6 / 8, two types); "wide" the same
    deck with lj/cut/coul/cut 6 12 at skin 2 (K past 352 from n = 6); each
    with every atom displaced uniformly in [-jiggle, jiggle] (numpy seed);
    "mixture" mixture_arrays(21, n, seed): 21 types, a cut per type pair,
    skin 0.3."""
    from lammps_plugins_tpu_torch.api.scenes import charged_melt, lj_melt
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.core.box import Box
    from lammps_plugins_tpu_torch.core.state import State
    from lammps_plugins_tpu_torch.fixes.nve import FixNVE
    from lammps_plugins_tpu_torch.potentials.ljcut import (PairLJCut,
                                                           PairLJCutCoulCut)
    from lammps_plugins_tpu_torch.run.simulation import Engine
    kw = dict(dtype=dtype, device=device)
    if kind == "mixture":
        x, types, length, coeffs = mixture_arrays(21, n, seed)
        pair = PairLJCut(3.0, ntypes=21, **kw)
        for c in coeffs:
            pair.set_coeff(*c)
        st = State.create(x=x, type=types, mass=np.ones(22),
                          box=Box.orthogonal([length] * 3, **kw))
        return Engine(st, pair, [FixNVE()], units.LJ, skin=0.3)
    deck = lj_melt(n, **kw) if kind == "lj" else charged_melt(n, **kw)
    if kind == "wide":
        pair = PairLJCutCoulCut(6.0, 12.0, ntypes=2, qqr2e=deck.units.qqr2e,
                                **kw)
        pair.set_coeff(1, 1, 0.01, 2.5)
        pair.set_coeff(2, 2, 0.01, 3.4)
        deck = dataclasses.replace(deck, pair=pair, skin=2.0)
    st = deck.state
    x = st.x.double().cpu().numpy() + np.random.default_rng(seed).uniform(
        -jiggle, jiggle, st.x.shape)
    deck.state = st.replace(x=torch.as_tensor(x, **kw))
    return deck.engine()
