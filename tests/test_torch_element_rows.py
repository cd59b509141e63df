"""dedflow_tpu_torch element bodies == the JAX package's (float64, 1e-12).

Random element inputs made with numpy from a seed go through the JAX
bodies (`pallas_kernels.res_rows_call` / `lhs_rows_call` with
backend="xla", the plain twins of the Pallas kernels) and through the
port's `element_rows.res_rows` / `lhs_rows`. The geometry comes from
random positively oriented tets, plus degenerate (dead-cell) columns whose
det = 0 must give exact zeros. Relative error = max|port - jax| / max|jax|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedflow_tpu.app.scenarios import reference_scenario_config
from dedflow_tpu.fem import element as jel
from dedflow_tpu.fem import ns
from dedflow_tpu.fem import pallas_kernels as pk
from dedflow_tpu_torch.config import Physics, TimeScheme
from dedflow_tpu_torch.fem import element as tel
from dedflow_tpu_torch.fem import element_rows as er

NE, NDEAD = 48, 8
@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tier-1 run shares the CPU's cores among its
    workers, and torch's own thread pool would oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


PHYS = Physics()
SCHEME = TimeScheme()


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def elems():
    """(NE + NDEAD, 4, 3) vertex coordinates: jittered unit tets, then
    degenerate all-equal vertices (the dead-cell geometry)."""
    rng = np.random.default_rng(7)
    ref = np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    x = 0.1 * (ref[None] + 0.2 * rng.standard_normal((NE, 4, 3)))
    x += rng.standard_normal((NE, 1, 3))
    neg = np.linalg.det(x[:, 1:] - x[:, :1]) < 0
    x[neg] = x[neg][:, [0, 2, 1, 3]]  # positive orientation
    dead = np.repeat(rng.standard_normal((NDEAD, 1, 3)), 4, axis=1)
    return np.concatenate([x, dead])


def _geometry_both(x):
    return jel.tet_geometry(jnp.asarray(x)), tel.tet_geometry(torch.as_tensor(x))


def test_tet_geometry_matches_jax(elems):
    jg, tg = _geometry_both(elems)
    for name in ("inv_j", "det_j", "shgrad", "metric"):
        assert rel(getattr(tg, name).numpy(), getattr(jg, name)) < 1e-12, name
    assert (tg.det_j[NE:] == 0).all() and (tg.shgrad[NE:] == 0).all()
    forn = np.arange(elems.shape[0]) % 4
    nv_j = jel.face_normals(jg.inv_j, jg.det_j, jnp.asarray(forn))
    nv_t = tel.face_normals(tg.inv_j, tg.det_j, torch.as_tensor(forn))
    assert rel(nv_t.numpy(), nv_j) < 1e-12
    inv_j, det_j = jel.inv3x3(jnp.asarray(elems[:NE, :3] - elems[:NE, 3:]))
    inv_t, det_t = tel.inv3x3(torch.as_tensor(elems[:NE, :3] - elems[:NE, 3:]))
    assert rel(inv_t.numpy(), inv_j) < 1e-12 and rel(det_t.numpy(), det_j) < 1e-12


def test_geometry_rows_match_jax(elems):
    jg, tg = _geometry_both(elems)
    assert rel(
        er.res_geom_rows(tg.shgrad, tg.det_j, tg.metric).numpy(),
        pk.res_geom_rows(jg.shgrad, jg.det_j, jg.metric),
    ) < 1e-12
    assert rel(
        er.lhs_geom_rows(tg.shgrad, tg.det_j, tg.metric).numpy(),
        pk.lhs_geom_rows(jg.shgrad, jg.det_j, jg.metric),
    ) < 1e-12


def _res_inputs(elems, seed):
    jg, _ = _geometry_both(elems)
    geom = np.asarray(pk.res_geom_rows(jg.shgrad, jg.det_j, jg.metric))
    state = np.random.default_rng(seed).standard_normal((48, elems.shape[0]))
    return np.concatenate([geom, state])  # (67, E)


def _lhs_inputs(elems, seed):
    jg, _ = _geometry_both(elems)
    geom = np.asarray(pk.lhs_geom_rows(jg.shgrad, jg.det_j, jg.metric))
    u = np.random.default_rng(seed).standard_normal((12, elems.shape[0]))
    return np.concatenate([geom[:12], u, geom[12:]])  # (27, E)


@pytest.mark.parametrize("batched", [False, True], ids=["rows", "slabs"])
def test_res_rows_matches_jax(elems, batched):
    inp = _res_inputs(elems, 1)
    if batched:  # (S, 67, E): the lattice's slab-major layout
        inp = np.stack([inp, _res_inputs(elems, 2), _res_inputs(elems, 3)])
    ref = pk.res_rows_call(jnp.asarray(inp), PHYS, SCHEME, backend="xla")
    got = er.res_rows(
        torch.as_tensor(inp), rho=PHYS.rho, mu=PHYS.mu, cp=PHYS.cp, kappa=PHYS.kappa,
        fb=PHYS.body_force, dt=SCHEME.dt,
    )
    assert got.shape == ref.shape
    assert rel(got.numpy(), ref) < 1e-12
    assert (got[..., NE:] == 0).all() and torch.isfinite(got).all()


@pytest.mark.parametrize("ncomp", [16, 18])
@pytest.mark.parametrize("batched", [False, True], ids=["rows", "slabs"])
def test_lhs_rows_matches_jax(elems, ncomp, batched):
    inp = _lhs_inputs(elems, 4)
    if batched:
        inp = np.stack([inp, _lhs_inputs(elems, 5)])
    ref = np.asarray(pk.lhs_rows_call(jnp.asarray(inp), PHYS, SCHEME, backend="xla"))
    ref = ref.reshape(*ref.shape[:-2], 16, 18, ref.shape[-1])[..., :ncomp, :]
    ref = ref.reshape(*ref.shape[:-3], 16 * ncomp, ref.shape[-1])
    got = er.lhs_rows(
        torch.as_tensor(inp), rho=PHYS.rho, mu=PHYS.mu, f1=SCHEME.fact_dw,
        f2=SCHEME.fact_w, dt=SCHEME.dt, ncomp=ncomp,
    )
    assert got.shape == ref.shape
    assert rel(got.numpy(), ref) < 1e-12
    assert (got[..., NE:] == 0).all() and torch.isfinite(got).all()


def test_alpha_states_and_norms_match_jax():
    rng = np.random.default_rng(9)
    state = [rng.standard_normal((30, 6)) for _ in range(3)]
    scheme = reference_scenario_config().time
    wa_j, dwa_j = ns.alpha_states(*(jnp.asarray(a) for a in state), scheme)
    wa_t, dwa_t = er.alpha_states(*(torch.as_tensor(a) for a in state), TimeScheme())
    assert rel(wa_t.numpy(), wa_j) < 1e-14 and rel(dwa_t.numpy(), dwa_j) < 1e-14
    assert rel(er.field_norms(wa_t).numpy(), ns.field_norms(wa_j)) < 1e-14
