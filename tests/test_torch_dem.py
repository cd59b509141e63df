"""dedflow_tpu_torch DEM == the JAX package's dedflow_tpu/dem (CPU).

Inputs are made with numpy from a seed and handed to both packages; the
port runs on the CPU in float64 unless stated (its plain versions, the
kernel's plain twin included). Tolerances: max|port - jax| / max|jax|.

- cells: `build_buckets`, `candidate_lists` (300 particles, with and
  without bucket overflow), `to_grid` pid/mask and `from_grid` (with a
  `prev` seed and an overflowing cell, K = 2) equal as integers / exactly:
  this pins the stable-sort tie order and the dropped scatters;
- contact: `pair_forces`, `wall_forces` and `forces` at 1e-12 (with and
  without the tangential term);
- trajectories: `dem_run` over 40 substeps at 1e-10; `dem_run_grid` with
  an external force over 20 substeps, rebuild_every=5, at 1e-10;
- K11: the plain twin `grid_pair_forces` against the JAX sweep at 1e-12
  (f64, K = 2, 3, 5, 11), and in float32 against the JAX TPU kernel run in
  interpret mode at the JAX test's bar (rtol 2e-5, atol 1e-4);
- `grid_pair_forces_cuda` on a CPU tensor is the plain twin; `shard=`
  raises naming ROADMAP A16.

torch runs with one intra-op thread in this module (restored after it):
with several, about one run in four on a shared CPU host gave one
thread's chunk of a float64 `torch.sqrt` results up to 2e-11 away from the
others' on its first call, which a near-threshold contact turns into a
force difference of 1e-9.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedflow_tpu.dem import cells as jcells
from dedflow_tpu.dem import contact as jcontact
from dedflow_tpu.dem import grid as jgrid
from dedflow_tpu.dem import integrate as jint
from dedflow_tpu.dem.particles import particle_state as jparticles
from dedflow_tpu_torch import interop
from dedflow_tpu_torch.dem import cells as tcells
from dedflow_tpu_torch.dem import contact as tcontact
from dedflow_tpu_torch.dem import grid as tgrid
from dedflow_tpu_torch.dem import integrate as tint


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def cloud(p, seed, lo=0.05, hi=0.95, radius=0.05, vscale=0.1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, size=(p, 3))
    v = rng.normal(scale=vscale, size=(p, 3))
    return x, v, radius


def both(x, v, radius, mass=1.0):
    """The same particles as a JAX ParticleState and a port one (f64)."""
    return (
        jparticles(x, v, mass=mass, radius=radius),
        interop.particles_from_numpy(x, v, mass, radius, device="cpu"),
    )


def tgrid_cfg(grid):
    return tcells.CellGrid(**dataclasses.asdict(grid))


@pytest.mark.parametrize("capacity", [24, 2], ids=["no-overflow", "overflow"])
def test_buckets_and_candidates_equal_jax(capacity):
    x, _, _ = cloud(300, seed=0)
    grid = jcells.make_grid([0, 0, 0], [1, 1, 1], cell_size=0.12, capacity=capacity)
    tg = tgrid_cfg(grid)
    assert (jcells.cell_stats(grid, x)["overflow"] > 0) == (capacity == 2)
    jb = jcells.build_buckets(grid, jnp.asarray(x))
    tb = tcells.build_buckets(tg, torch.as_tensor(x))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    jc = jcells.candidate_lists(grid, jnp.asarray(x), jb)
    tc = tcells.candidate_lists(tg, torch.as_tensor(x), tb)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tcells.cell_stats(tg, x) == jcells.cell_stats(grid, x)


def test_make_grid_matches_jax():
    for args in (([0, 0, 0], [1, 1, 1], 0.12, 24), ([-0.2, 0, 0.1], [2, 0.4, 0.9], 0.07, 5)):
        assert dataclasses.asdict(tcells.make_grid(*args)) == dataclasses.asdict(
            jcells.make_grid(*args)
        )


@pytest.fixture(scope="module")
def overflow_grid():
    """K = 2 on a cloud with cells holding 3+ particles: some particles
    overflow and are dropped by to_grid."""
    x, v, r = cloud(200, seed=1, lo=0.05, hi=0.45, radius=0.03)
    grid = jcells.make_grid([0, 0, 0], [0.5, 0.5, 0.5], cell_size=0.1, capacity=2)
    assert jcells.cell_stats(grid, x)["overflow"] > 0
    return grid, both(x, v, r)


def test_to_grid_from_grid_equal_jax(overflow_grid):
    grid, (js, ts) = overflow_grid
    p = js.num_particle
    jgs = jgrid.to_grid(grid, js, p)
    tgs = tgrid.to_grid(tgrid_cfg(grid), ts, p)
    np.testing.assert_array_equal(tgs.pid.numpy(), np.asarray(jgs.pid))
    np.testing.assert_array_equal(tgs.mask.numpy(), np.asarray(jgs.mask))
    for c in range(3):
        np.testing.assert_array_equal(tgs.pos[c].numpy(), np.asarray(jgs.pos[c]))
        np.testing.assert_array_equal(tgs.vel[c].numpy(), np.asarray(jgs.vel[c]))
    np.testing.assert_array_equal(tgs.radius.numpy(), np.asarray(jgs.radius))
    # move the grid state, then back to particles, with and without a seed
    jgs2 = dataclasses.replace(jgs, pos=tuple(a + 0.01 * jgs.mask for a in jgs.pos))
    tgs2 = dataclasses.replace(tgs, pos=tuple(a + 0.01 * tgs.mask for a in tgs.pos))
    for jprev, tprev in ((js, ts), (None, None)):
        jout = jgrid.from_grid(grid, jgs2, p, prev=jprev)
        tout = tgrid.from_grid(tgrid_cfg(grid), tgs2, p, prev=tprev)
        for name in ("x", "v", "radius"):
            np.testing.assert_array_equal(
                getattr(tout, name).numpy(), np.asarray(getattr(jout, name)), err_msg=name
            )


PRMS = {
    "frictionless": dict(k_n=1e3, gamma_n=1.0),
    "tangential": dict(k_n=2e3, gamma_n=3.0, mu=0.3, gamma_t=2.0),
}


@pytest.mark.parametrize("prm", PRMS.values(), ids=PRMS.keys())
def test_pair_and_wall_forces_match_jax(prm):
    x, v, r = cloud(300, seed=2)
    js, ts = both(x, v, r)
    grid = jcells.make_grid([0, 0, 0], [1, 1, 1], cell_size=0.12, capacity=24)
    jp, tp = jcontact.ContactParams(**prm), tcontact.ContactParams(**prm)
    jc = jcells.candidate_lists(grid, js.x, jcells.build_buckets(grid, js.x))
    tc = tcells.candidate_lists(tgrid_cfg(grid), ts.x, tcells.build_buckets(tgrid_cfg(grid), ts.x))
    ref = jcontact.pair_forces(js.x, js.v, js.radius, jc, jp)
    assert np.abs(np.asarray(ref)).max() > 0  # the cloud has contacts
    assert rel(tcontact.pair_forces(ts.x, ts.v, ts.radius, tc, tp), ref) < 1e-12
    lo, hi = (0.1, 0.1, 0.1), (0.9, 0.9, 0.9)  # walls inside the cloud
    ref = jcontact.wall_forces(js.x, js.v, js.radius, lo, hi, jp)
    assert rel(tcontact.wall_forces(ts.x, ts.v, ts.radius, lo, hi, tp), ref) < 1e-12
    small = slice(0, 60)
    ref = jcontact.brute_force_pairs(js.x[small], js.v[small], js.radius[small], jp)
    got = tcontact.brute_force_pairs(ts.x[small], ts.v[small], ts.radius[small], tp)
    assert rel(got, ref) < 1e-12


def dem_cfgs(grid, **kw):
    jcfg = jint.DEMConfig(grid=grid, **kw)
    return jcfg, interop.dem_config_from_dict(dataclasses.asdict(jcfg))


def test_dem_config_crosses_over():
    grid = jcells.make_grid([0, 0, 0], [1, 1, 1], cell_size=0.12, capacity=5)
    jcfg, tcfg = dem_cfgs(
        grid, contact=jcontact.ContactParams(k_n=5.0, mu=0.1), dt=2e-4,
        walls_lo=(0, 0, 0), walls_hi=(1, 1, 1), linear_drag=0.5,
    )
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


@pytest.fixture(scope="module")
def settling():
    """A 150-particle cloud with walls, gravity, drag and an external force."""
    x, v, r = cloud(150, seed=7, lo=0.08, hi=0.92, radius=0.03, vscale=0.05)
    grid = jcells.make_grid([0, 0, 0], [1, 1, 1], cell_size=0.08, capacity=3)
    jcfg, tcfg = dem_cfgs(
        grid, contact=jcontact.ContactParams(k_n=2e3, gamma_n=3.0), gravity=(0.0, 0.0, -9.81),
        dt=1e-4, walls_lo=(0, 0, 0), walls_hi=(1, 1, 1), linear_drag=0.5,
    )
    ext = np.random.default_rng(8).normal(scale=0.2, size=x.shape)
    return jcfg, tcfg, both(x, v, r), ext


def test_forces_match_jax(settling):
    jcfg, tcfg, (js, ts), ext = settling
    ref = jint.forces(jcfg, js, jnp.asarray(ext))
    assert rel(tint.forces(tcfg, ts, torch.as_tensor(ext)), ref) < 1e-12
    assert rel(tint.kinetic_energy(ts), jint.kinetic_energy(js)) < 1e-12


def test_dem_run_matches_jax(settling):
    jcfg, tcfg, (js, ts), ext = settling
    ref = jint.dem_run(jcfg, js, 40, ext=jnp.asarray(ext))
    got = tint.dem_run(tcfg, ts, 40, ext=torch.as_tensor(ext))
    for name in ("x", "v", "a"):
        assert rel(getattr(got, name), getattr(ref, name)) < 1e-10, name


def test_dem_run_grid_matches_jax(settling):
    jcfg, tcfg, (js, ts), ext = settling
    ref = jgrid.dem_run_grid(jcfg, js, 20, rebuild_every=5, ext=jnp.asarray(ext))
    got = tgrid.dem_run_grid(tcfg, ts, 20, rebuild_every=5, ext=torch.as_tensor(ext))
    for name in ("x", "v"):
        assert rel(getattr(got, name), getattr(ref, name)) < 1e-10, name
    with pytest.raises(NotImplementedError, match="A16"):
        tgrid.dem_run_grid(tcfg, ts, 1, shard=("mesh", "dd"))


def k_sweep_state(cap, dtype):
    """The JAX K-sweep test's cloud (tests/test_dem.py:331-362) on a grid of
    capacity `cap`, as a JAX GridState and the port's, in `dtype`."""
    rng = np.random.default_rng(cap)
    p = 400
    x = rng.uniform(0.05, 0.55, size=(p, 3))
    v = rng.normal(scale=0.05, size=(p, 3))
    grid = jcells.make_grid([0, 0, 0], [0.6, 0.6, 0.6], cell_size=0.08, capacity=cap)
    jgs = jgrid.to_grid(grid, jparticles(x, v, radius=0.03, mass=1.0), p)
    jgs = jax.tree_util.tree_map(
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a, jgs
    )
    tgs = interop.grid_state_from_numpy(
        [np.asarray(a) for a in jgs.pos], [np.asarray(a) for a in jgs.vel],
        np.asarray(jgs.radius), np.asarray(jgs.mask), np.asarray(jgs.pid),
        device="cpu", dtype=torch.float64 if dtype == jnp.float64 else torch.float32,
    )
    return grid, jgs, tgs


@pytest.mark.parametrize("cap", [2, 3, 5, 11])
def test_k11_plain_twin_matches_jax_sweep(cap):
    grid, jgs, tgs = k_sweep_state(cap, jnp.float64)
    prm = dict(k_n=2e3, gamma_n=3.0, mu=0.3, gamma_t=2.0)
    ref = jgrid.grid_pair_forces(grid, jgs, jcontact.ContactParams(**prm))
    got = tgrid.grid_pair_forces_cuda(tgrid_cfg(grid), tgs, tcontact.ContactParams(**prm))
    for c in range(3):
        assert np.abs(np.asarray(ref[c])).max() > 0
        assert rel(got[c], ref[c]) < 1e-12, c


def test_k11_plain_twin_f32_matches_tpu_kernel_interpret():
    grid, jgs, tgs = k_sweep_state(2, jnp.float32)
    prm = dict(k_n=2e3, gamma_n=3.0)
    ref = jgrid.grid_pair_forces_pallas(grid, jgs, jcontact.ContactParams(**prm), interpret=True)
    got = tgrid.grid_pair_forces(tgrid_cfg(grid), tgs, tcontact.ContactParams(**prm))
    for c in range(3):
        assert got[c].dtype == torch.float32
        np.testing.assert_allclose(got[c].numpy(), np.asarray(ref[c]), rtol=2e-5, atol=1e-4)
