"""The hand-written CUDA kernels of dedflow_tpu_torch == their plain versions.

Every test here needs a card (marker `cuda`) and skips without one. The
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_cuda.py

(`--noconftest` because tests/conftest.py configures JAX.) Inputs are
made with numpy from a seed on an odd-sized box, float32 on the card.
Relative error = max|kernel - plain| / max|plain|; the tolerances are
float32 roundoff (different sum orders, hardware rsqrtf), as in
chip_smoke.py, which runs the same comparisons at box 55.
"""

import numpy as np
import pytest
import torch

from dedflow_tpu_torch.app.scenarios import reference_initial_state, reference_scenario_config
from dedflow_tpu_torch.fem import lattice as lat
from dedflow_tpu_torch.fem.element_rows import alpha_states
from dedflow_tpu_torch.interop import state_from_numpy
from dedflow_tpu_torch.mesh.gen import box_mesh
from dedflow_tpu_torch.solver.newton import NSSolver
from dedflow_tpu_torch.sparse.dia_kernels import dia_matvec, dia_matvec_plain
from dedflow_tpu_torch.sparse.fsbsr import diag_add_rows, keep_pc_rows

pytestmark = pytest.mark.cuda

BOX = (7, 5, 6)


def rel(got, ref) -> float:
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    mesh = box_mesh(*BOX)
    solver = NSSolver(mesh, reference_scenario_config(), device="cuda")
    wg, dwgold, dwg = reference_initial_state(mesh)
    dwg = dwg + 0.1 * np.random.default_rng(5).standard_normal(dwg.shape)
    state = state_from_numpy(wg, dwgold, dwg, "cuda", torch.float32)
    wa, dwa = alpha_states(*state, solver.cfg.time)
    return solver, state, wa, dwa


def test_k1_kernel_matches_plain(card):
    solver, _, wa, dwa = card
    args = (solver.lctx, wa.T.contiguous(), dwa.T.contiguous(),
            solver.cfg.physics, solver.cfg.time)
    before = lat.residual_volume.launches
    got = lat.residual_volume(*args)
    assert lat.residual_volume.launches == before + 1
    assert torch.isfinite(got).all()
    assert rel(got, lat.residual_volume_plain(*args)) < 2e-5


def test_k2_kernel_matches_plain(card):
    solver, _, wa, dwa = card
    phys, scheme, lctx = solver.cfg.physics, solver.cfg.time, solver.lctx
    keep = keep_pc_rows(solver.mask_t, torch.float32)
    add = diag_add_rows(solver.mask_t, torch.float32)
    band, lo = lat._masked_face_band(
        solver.face_ctxs, wa, dwa, phys, scheme, len(lctx.offsets), keep
    )
    wa_t = wa.T.contiguous()
    for keep16, add16, b in (
        (keep[:16].contiguous(), add[:16].contiguous(), band),  # masked, facets
        (torch.ones_like(keep[:16]), torch.zeros_like(add[:16]), None),  # K2'
    ):
        before = lat.jacobian_volume.launches
        got = lat.jacobian_volume(lctx, wa_t, phys, scheme, keep16, add16, b, lo)
        assert lat.jacobian_volume.launches == before + 1
        assert torch.isfinite(got).all()  # dead cells give 0, never NaN
        ref = lat.jacobian_volume_plain(lctx, wa_t, phys, scheme, keep16, add16, b, lo)
        assert rel(got, ref) < 2e-5


def test_k3_kernel_matches_plain(card):
    solver, _, wa, dwa = card
    jm = lat.assemble_jacobian_t(
        solver.lctx, solver.face_ctxs, solver.mask_t, wa, dwa,
        solver.cfg.physics, solver.cfg.time,
    )
    x = torch.as_tensor(
        np.random.default_rng(6).standard_normal((6, solver.lctx.num_node)),
        dtype=torch.float32, device="cuda",
    )
    for scal in (jm.scal, torch.zeros_like(jm.scal)):
        before = dia_matvec.launches
        got = dia_matvec(jm.data, scal, x, jm.offsets)
        assert dia_matvec.launches == before + 1
        assert rel(got, dia_matvec_plain(jm.data, scal, x, jm.offsets)) < 1e-5


def test_kernels_refuse_what_they_cannot_take(card):
    """A CUDA tensor never takes the plain version: float64 raises."""
    solver, _, wa, dwa = card
    with pytest.raises(ValueError, match="float32"):
        dia_matvec(
            torch.zeros((1, 16, 8), dtype=torch.float64, device="cuda"),
            torch.zeros((2, 8), dtype=torch.float64, device="cuda"),
            torch.zeros((6, 8), dtype=torch.float64, device="cuda"), (0,),
        )
    with pytest.raises(ValueError, match="float32"):
        lat.residual_volume(
            solver.lctx, wa.T.double().contiguous(), dwa.T.double().contiguous(),
            solver.cfg.physics, solver.cfg.time,
        )


def test_step_on_card_matches_cpu_f64(card):
    """One step_fixed(num_newton=2): float32 kernels on the card against the
    float64 plain versions on the CPU. The float32 GMRES stops at rtol 1e-4;
    the new states agree to ~1e-5 of their size (chip_smoke.py phase 4)."""
    solver, state, _, _ = card
    cpu = NSSolver(box_mesh(*BOX), reference_scenario_config(), device="cpu")
    got = solver.step_fixed(*state, num_newton=2)
    ref = cpu.step_fixed(*(t.cpu().double() for t in state), num_newton=2)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        assert rel(g, r) < 1e-4
