"""pair_style aeam of the port (potentials/aeam.py) against the JAX
package's, float64 on the CPU, on the same lists.

Both packages read the synthetic files of tests/data (make_aeam_synthetic.py)
and build the same jiggled fcc Al-Si scenes; the JAX Engine's device
rebuild makes the lists, which reach the port through convert.py.  Held to
1e-9 relative (max |a - b| / max |b|): energy, forces, the strain virial
and energy_peratom, in every branch of the force path:

  fast      symmetric grids, a compacted angular (Si) minority
  majority  an angular majority: forces are autograd of the energy
  pure_al   no angular atom: the angular part skipped
  asym      asymmetric grids: the edge-cotangent autograd and the mirror
            combine over the rebuild's mirror table
  poly      poly_mode (piecewise-Chebyshev refits) against JAX poly_mode

plus force_pass_deviation (zero for the synthetic file, non-zero and equal
for a Si-Si density that reaches into the 1.5 A shell), the port's fast
path against its own autograd, the angular reaction table, and the
device rebuild's lists at the AEAM cutoffs (skin 1.2, K > 128) element for
element against JAX's, with no cell and no mirror table.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lammps_plugins_tpu_torch import convert
from torch_parity import SYNTH_AEAM, SYNTH_AEAM_ASYM, rel_err

A = 4.045
CASES = ("fast", "majority", "pure_al", "asym", "poly")
QUANTITIES = ("energy", "forces", "virial", "energy_peratom")


def _sites(case, n, rng):
    if case == "pure_al":
        return np.zeros(0, int)
    if case == "majority":
        return rng.choice(n, size=int(0.6 * n), replace=False)
    return np.array([5, 17, 40, 77])


def jax_scene(case="fast", nc=3, jiggle=0.06, seed=3, skin=0.8,
              tables=None):
    """A JAX Engine (f64, NVT 863 K) on the nc^3 fcc Al cell with the
    case's Si sites, jiggled (normal, numpy seed), after one device
    rebuild; tables replaces the file's parsed tables."""
    import jax.numpy as jnp
    from lammps_plugins_tpu.core import units
    from lammps_plugins_tpu.core.box import Box
    from lammps_plugins_tpu.core.lattice import Lattice, create_atoms_box
    from lammps_plugins_tpu.core.state import State
    from lammps_plugins_tpu.fixes.nvt import FixNVT
    from lammps_plugins_tpu.potentials.aeam import AEAM
    from lammps_plugins_tpu.run.simulation import Engine
    box = Box.orthogonal([A * nc] * 3)
    pos, types = create_atoms_box(Lattice.fcc(A), box, [1, 1, 1, 1])
    types = np.asarray(types).copy()
    rng = np.random.default_rng(seed)
    types[_sites(case, len(types), rng)] = 2
    pos = pos + rng.normal(scale=jiggle, size=pos.shape)
    path = SYNTH_AEAM_ASYM if case == "asym" else SYNTH_AEAM
    pair = AEAM.from_file(path, ["Al", "Si"], poly_mode=case == "poly")
    if tables is not None:
        pair = AEAM(tables, pair.typemap_np)
    st = State.create(x=jnp.asarray(pos), type=types, box=box,
                      mass=pair.masses)
    eng = Engine(st, pair, [FixNVT(863.0, 863.0, 0.1)], units.METAL,
                 device_rebuild=True, skin=skin)
    eng.rebuild_neighbors()
    pair.prepare(np.asarray(eng.state.type))
    return eng


def port_of(jeng, poly_mode=False):
    """(pair, state, nbr) of the port holding the JAX engine's data."""
    jp = jeng.pair
    pair = convert.aeam_from_tables(jp.tables, jp.typemap_np,
                                    poly_mode=poly_mode)
    st = convert.state_from_numpy(jeng.state)
    pair.prepare(st.type.numpy())
    return pair, st, convert.neighbor_data_from_numpy(jeng.nbr)


def _quantities(pair, x, types, nbr, h, to_np):
    e, f, w = pair.energy_force_virial(x, types, nbr, h)
    return {"energy": to_np(e), "forces": to_np(pair.forces(x, types, nbr,
                                                           h)),
            "virial": to_np(w),
            "energy_peratom": to_np(pair.energy_peratom(x, types, nbr, h)),
            "autograd_forces": to_np(f)}


@pytest.fixture(scope="module")
def both():
    """{case: (JAX quantities, port quantities, port pair)}."""
    out = {}
    for case in CASES:
        jeng = jax_scene(case)
        js = jeng.state
        jq = _quantities(jeng.pair, js.x, js.type, jeng.nbr, js.box.h,
                         np.asarray)
        pair, st, nbr = port_of(jeng, poly_mode=case == "poly")
        pq = _quantities(pair, st.x, st.type, nbr, st.box.h,
                         lambda t: t.detach().numpy())
        out[case] = (jq, pq, pair, nbr)
    return out


def test_cases_take_their_branches(both):
    fast, majority, pure, asym, poly = (both[c][2] for c in CASES)
    assert fast._sym_grids and fast._ang_sel.shape[0] == 4
    assert majority._ang_sel is None
    assert pure._ang_sel.shape[0] == 0
    assert not asym._sym_grids and both["asym"][3].lists["main"].mirror \
        is not None
    assert poly.poly is not None and fast.poly is None


@pytest.mark.parametrize("quantity", QUANTITIES)
@pytest.mark.parametrize("case", CASES)
def test_matches_jax(both, case, quantity):
    jq, pq, _, _ = both[case]
    assert np.abs(jq[quantity]).max() > 0
    assert rel_err(pq[quantity], jq[quantity]) <= 1e-9


@pytest.mark.parametrize("case", ["fast", "pure_al", "asym"])
def test_forces_equal_the_energy_gradient(both, case):
    """The fast path (and the mirror path) against autograd of the same
    energy, in the port."""
    _, pq, _, _ = both[case]
    assert rel_err(pq["forces"], pq["autograd_forces"]) <= 1e-9


def test_reaction_table_lists_each_angular_entry_once(both):
    """Every masked-in angular entry appears once, in its target owner's
    row; the rest of the table is the zero row E."""
    _, _, pair, nbr = both["fast"]
    table = pair.rebuild_tables(nbr)["aeam:react"]
    main = nbr.lists["main"]
    sel = pair._ang_sel
    n, K = main.idx.shape
    E = sel.shape[0] * K
    owner = torch.cat([torch.arange(n), nbr.ghosts.owner])
    want = {}
    for a, i in enumerate(sel.tolist()):
        for k in range(K):
            if main.mask[i, k]:
                want.setdefault(int(owner[main.idx[i, k]]), []).append(
                    a * K + k)
    got = {}
    for j in range(n):
        row = [int(e) for e in table[j] if e < E]
        if row:
            got[j] = row
    assert got == want and len(want) > 0


def test_engine_builds_the_reaction_table_with_the_lists():
    from lammps_plugins_tpu_torch.api.scenes import alsi_sample
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nvt import FixNVT
    from lammps_plugins_tpu_torch.potentials.aeam import AEAM
    from lammps_plugins_tpu_torch.run.simulation import Engine
    cpu = dict(dtype=torch.float64, device="cpu")
    eng = Engine(alsi_sample(nc=3, si_fraction=0.05, **cpu),
                 AEAM.from_file(SYNTH_AEAM, ["Al", "Si"], **cpu),
                 [FixNVT(863.0, 863.0, 0.1)], units.METAL, skin=1.2)
    eng.rebuild_neighbors()
    assert torch.equal(eng.nbr.pair_tables["aeam:react"],
                       eng.pair._reaction_table(eng.nbr))


def _shell_tables():
    """The synthetic tables with a Si-Si density that reaches past
    cut - 1.5 (into the shell the reference's force pass reads)."""
    from lammps_plugins_tpu.potentials.tables import read_aeam
    t = read_aeam(SYNTH_AEAM)
    r = np.arange(int(t.nr[1, 1]) + 1) * t.dr[1, 1]
    rhor = [list(row) for row in t.rhor]
    f = np.exp(-1.2 * (r - 2.35)) * np.clip(1.0 - r / t.cut[1, 1], 0, None)
    f[0] = 0.0
    rhor[1][1] = f
    return dataclasses.replace(t, rhor=rhor)


@pytest.mark.parametrize("tables", ["file", "shell"])
def test_force_pass_deviation_matches_jax(tables):
    t = _shell_tables() if tables == "shell" else None
    jeng = jax_scene("majority", tables=t)
    js = jeng.state
    jd = np.asarray(jeng.pair.force_pass_deviation(js.x, js.type, jeng.nbr,
                                                   js.box.h))
    pair, st, nbr = port_of(jeng)
    if t is not None:
        pair = convert.aeam_from_tables(t, pair.typemap_np)
        pair.prepare(st.type.numpy())
    pd = pair.force_pass_deviation(st.x, st.type, nbr, st.box.h).numpy()
    if tables == "file":
        assert np.abs(jd).max() == 0.0 and np.abs(pd).max() == 0.0
    else:
        assert np.abs(jd).max() > 1e-3
        assert rel_err(pd, jd) <= 1e-9


@pytest.fixture(scope="module", params=[None, 224, 256])
def rebuilt(request):
    """JAX and port device rebuilds of the jiggled nc=4 scene with four Si
    (f64, skin 1.2) on the JAX Engine's plan (K = 144), or on that plan
    with K = 224 or 256."""
    from lammps_plugins_tpu.neighbor import device_build as jdb
    from lammps_plugins_tpu_torch.neighbor import device_build as pdb
    jeng = jax_scene("fast", nc=4, skin=1.2)
    js = jeng.state
    h, h_inv, lo = jeng._box_dev
    plan = jeng._plan
    if request.param:
        plan = dataclasses.replace(plan, k_caps=(("main", request.param),))
    _, _, jnbr, jflags = jdb.device_rebuild(
        plan, js.x, js.image, js.type, h, h_inv, lo, jeng._cut_mats_dev)
    ps = convert.state_from_numpy(js)
    as_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    pplan = convert.plan_from_fields(plan)
    _, _, pnbr, pflags = pdb.device_rebuild(
        pplan, ps.x, ps.image, ps.type, as_t(h), as_t(h_inv), as_t(lo),
        jeng.pair.neighbor_requests())
    return (pplan, jnbr, {k: int(v) for k, v in jflags.items()}, pnbr,
            pdb.flags_to_host(pflags))


def test_aeam_plan_has_one_main_tier_and_no_tables_it_never_reads(rebuilt):
    plan, _, _, pnbr, pflags = rebuilt
    assert [k for k, _ in plan.k_caps] == ["main"]
    assert plan.cell_tiers == () and plan.mirror_tiers == ()
    assert dict(plan.k_caps)["main"] > 128
    assert pnbr.cells is None and list(pnbr.lists) == ["main"]
    assert all(getattr(pnbr.lists["main"], f) is None
               for f in ("mirror", "idxT", "mirT", "rtgt"))
    assert not pflags["k_overflow:main"]


def test_rebuild_lists_match_jax_element_for_element(rebuilt):
    _, jnbr, jflags, pnbr, pflags = rebuilt
    for key in ("count:k:main", "k_overflow:main", "candcell_overflow",
                "count:candcell", "count:ghost"):
        assert pflags[key] == jflags[key]
    jl, pl = jnbr.lists["main"], pnbr.lists["main"]
    for f in ("idx", "mask", "jtype"):
        np.testing.assert_array_equal(getattr(pl, f).numpy(),
                                      np.asarray(getattr(jl, f)))
    np.testing.assert_array_equal(pnbr.ghosts.owner.numpy(),
                                  np.asarray(jnbr.ghosts.owner))


def test_port_engine_plan_and_k_past_128():
    """The port Engine's own plan for the AEAM scene at skin 1.2: one main
    tier, no cell or mirror tier, and a K the quantizer takes past 128
    (the fine-cell candidate selection's old cap)."""
    from lammps_plugins_tpu_torch.api.scenes import alsi_sample
    from lammps_plugins_tpu_torch.core import units
    from lammps_plugins_tpu_torch.fixes.nvt import FixNVT
    from lammps_plugins_tpu_torch.potentials.aeam import AEAM
    from lammps_plugins_tpu_torch.run.simulation import Engine
    cpu = dict(dtype=torch.float32, device="cpu")
    eng = Engine(alsi_sample(nc=5, **cpu),
                 AEAM.from_file(SYNTH_AEAM, ["Al", "Si"], **cpu),
                 [FixNVT(863.0, 863.0, 0.1)], units.METAL, skin=1.2,
                 check_every=12)
    eng.rebuild_neighbors()
    p = eng._plan
    assert p.cell_tiers == () and p.mirror_tiers == ()
    kmax = int(eng.nbr.lists["main"].mask.sum(dim=1).max())
    assert 128 < kmax <= dict(p.k_caps)["main"]
