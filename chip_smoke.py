#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (dedflow_tpu_torch).

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one line each; the script exits non-zero at the first failure:
  1 card    nvidia-smi name and power limit, torch / CUDA versions
  2 build   nvcc builds the six kernel libraries from csrc/ in parallel
            (seconds, ptxas lines)
  lattice tier (box meshes):
  3 kernels at box_mesh(55, 55, 55) (998,250 tets), float32 on the card,
            K1-K3 each against its plain torch version on the same inputs,
            with times (CUDA events, after warm-up); then F, J, SpMV and
            GMRES(120) times of the assembled system
  4 slice   one step_fixed(num_newton=2) at box_mesh(12, 12, 12): the card
            (float32, kernels) against the CPU (float64, plain versions)
  5 main    NSSolver(box_mesh(55, 55, 55), reference_scenario_config(),
            device="cuda").step twice, with the kernel launch counts
  windowed irregular (WinELL) tier:
  6 kernels at delaunay_mesh(56**3) + RCM (about 1.18M tets), float32:
            K6 (residual and Jacobian rows), K7, K8 and K9 against their
            plain versions, times, then F, J, SpMV and GMRES(120)
  7 slice   the converted box 12 (lattice metadata dropped, RCM,
            use_lattice="winell", reference BCs with the Nitsche wall): one
            step_fixed(num_newton=2), card float32 against CPU float64
  8 main    NSSolver(that Delaunay mesh, reference_scenario_config(bcs=(),
            pin_pressure=True), device="cuda").step twice on the "winell"
            fastpath, with the launch counts of K6-K9
Then, on lines of their own: the kernels JSON object, the card's name and
power limit, and last {"ok": true, "device": {...}}. Without CUDA, or
without the dedflow_tpu_torch package beside it, it fails and prints no
result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback

FULL_BOX = (55, 55, 55)
SLICE_BOX = (12, 12, 12)
DELAUNAY_POINTS = 56**3  # 175,616 points, about 1.18M tets (bench.py:117,126)
SEED = 0

# Tolerances, relative = max|kernel - plain| / max|plain|, float32 on the card.
# The kernels and their plain versions sum in different orders and the
# kernels use the hardware rsqrtf/sqrtf: float32 roundoff, amplified by
# the cancellation in sums of element contributions.
TOL_K1 = 2e-5  # the JAX package's own fused-vs-unfused bar (lattice.py:749)
TOL_K2 = 2e-5
TOL_K3 = 1e-5  # 60 products per output row, no cancellation-heavy terms
TOL_K6 = 2e-5  # the element bodies of K1/K2 on element columns
TOL_K7 = 1e-5  # about 16 entries x 4 products per output row
TOL_K8 = 1e-5  # 4 to 40 contributions per node, one add each
TOL_K9 = 1e-5  # about 6.6 contributions per entry
# The 16 velocity/pressure components of a nodal block, by sub-block, in
# the element Jacobian's packed order (K6 rows ab*18+c). Their scales
# differ by orders of magnitude (the pressure rows are far smaller than the
# velocity block), so the Jacobian's kernels are held to their tolerance
# block by block, each against its own scale, as the products and
# residuals are equation by equation.
VP_BLOCKS = {"uu": range(0, 9), "up": range(9, 12), "pu": range(12, 15), "pp": range(15, 16)}
# Slice phase: a float32 GMRES stopped at rtol 1e-4 against a float64 one.
# Each Newton update is accurate to about 1e-4 of its own size and the
# second update corrects most of the first one's error, so the new states
# agree to about 1e-5 of their size or better (2.6e-6 measured on an H100).
TOL_SLICE = 1e-4

# The TPU kernels the three CUDA kernels replace (file:line of the kernel).
KERNELS = (
    ("K1 lattice residual", "dedflow_tpu_torch/csrc/lattice_residual.cu",
     "dedflow_tpu/fem/lattice.py:779"),
    ("K2 lattice jacobian", "dedflow_tpu_torch/csrc/lattice_jacobian.cu",
     "dedflow_tpu/fem/lattice.py:835"),
    ("K3 dia spmv", "dedflow_tpu_torch/csrc/dia_spmv.cu",
     "dedflow_tpu/sparse/dia_kernels.py:56"),
)
IRREGULAR_KERNELS = (
    ("K6 element rows (residual)", "dedflow_tpu_torch/csrc/element_rows.cu",
     "dedflow_tpu/fem/pallas_kernels.py:565"),
    ("K6 element rows (jacobian)", "dedflow_tpu_torch/csrc/element_rows.cu",
     "dedflow_tpu/fem/pallas_kernels.py:565"),
    ("K7 winell spmv", "dedflow_tpu_torch/csrc/winell_spmv.cu",
     "dedflow_tpu/sparse/win_kernels.py:55"),
    ("K8 stream reduce", "dedflow_tpu_torch/csrc/seg_reduce.cu",
     "dedflow_tpu/sparse/win_stream.py:251"),
    ("K9 ring reduce", "dedflow_tpu_torch/csrc/seg_reduce.cu",
     "dedflow_tpu/sparse/win_ring.py:356"),
)


class PhaseError(RuntimeError):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def rel_err(got, ref) -> tuple[float, float]:
    err = float((got.double() - ref.double()).abs().max())
    scale = float(ref.double().abs().max())
    return err, err / max(scale, 1e-300)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def alternate_ms(kernel, plain, reps_k: int, reps_p: int) -> tuple[float, float]:
    """Kernel and plain timed in turns (plain, kernel, kernel, plain)."""
    p1 = cuda_ms(plain, reps_p)
    k1 = cuda_ms(kernel, reps_k)
    k2 = cuda_ms(kernel, reps_k)
    p2 = cuda_ms(plain, reps_p)
    return (k1 + k2) / 2, (p1 + p2) / 2


def check(name: str, err_rel: float, tol: float) -> None:
    if not err_rel <= tol:  # also catches NaN
        raise PhaseError(f"{name}: relative error {err_rel:.3e} above {tol:.1e}")


def perturbed_state(mesh, device, dtype):
    """Reference initial state with a seeded perturbation of dwg (so every
    input row of the element bodies is non-zero), advanced by one predict."""
    import numpy as np

    from dedflow_tpu_torch.app.scenarios import (
        reference_initial_state,
        reference_scenario_config,
    )
    from dedflow_tpu_torch.interop import state_from_numpy
    from dedflow_tpu_torch.solver.newton import predict

    wg, dwgold, dwg = reference_initial_state(mesh)
    rng = np.random.default_rng(SEED)
    dwg = dwg + 0.1 * rng.standard_normal(dwg.shape)
    wg, dwgold, dwg = state_from_numpy(wg, dwgold, dwg, device, dtype)
    return wg, dwgold, predict(dwg, reference_scenario_config().time)


def phase_build() -> None:
    from dedflow_tpu_torch.utils import nvcc

    t0 = time.perf_counter()
    libs = nvcc.load([
        "lattice_residual", "lattice_jacobian", "dia_spmv",
        "element_rows", "winell_spmv", "seg_reduce",
    ])
    say(f"phase 2 build: {time.perf_counter() - t0:.2f} s wall for "
        f"{len(libs)} libraries (nvcc {nvcc.nvcc_path()})")
    for lib in libs.values():
        say(f"  {lib.name}: {lib.build_seconds:.2f} s")
        for ln in lib.ptxas:
            say(f"    {ln}")


def compare(label: str, kernel, plain, tol: float, parts=None) -> float:
    """Run a kernel twice and its plain version once on the same inputs;
    check that the two kernel runs are bit-identical (no atomics: results
    repeat from run to run) and print and check the relative error;
    return the max abs error. `parts` {name: view} checks each view of the
    output against its own scale (for outputs whose parts differ in size
    by orders of magnitude)."""
    import torch

    got, again, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise PhaseError(f"{label}: non-finite kernel output")
    if not torch.equal(got, again):
        raise PhaseError(f"{label}: two runs of the kernel differ")
    worst, rels = 0.0, {}
    for name, view in (parts or {"": lambda t: t}).items():
        err, rels[name] = rel_err(view(got), view(ref))
        say(f"  {label}{name}: max_abs_err={err:.3e} rel={rels[name]:.3e} (tol {tol:.0e})")
        worst = max(worst, err)
    for name, rel in rels.items():  # every part printed before the first failure
        check(label + name, rel, tol)
    return worst


def phase_kernels(solver) -> tuple[list, dict]:
    """Each kernel against its plain version at the solver's size. Returns
    per kernel [max_abs_err, ms, plain_ms] and the system timings.

    The finished Jacobian and its products are dominated by the unit
    diagonal of the Dirichlet rows (entries of 1 against element entries
    of about 1e-3 at box 55), so K2 and K3 are also compared unmasked
    (K2' mode: keep = 1, add = 0, no band), where the element scale sets
    the relative error."""
    import torch

    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.fem.element_rows import alpha_states
    from dedflow_tpu_torch.solver.krylov import gmres
    from dedflow_tpu_torch.solver.pc import NSFieldSplitPCT
    from dedflow_tpu_torch.sparse.dia_kernels import dia_matvec, dia_matvec_plain
    from dedflow_tpu_torch.sparse.fsbsr import diag_add_rows, keep_pc_rows

    phys, scheme = solver.cfg.physics, solver.cfg.time
    lctx, fctxs, mask_t = solver.lctx, solver.face_ctxs, solver.mask_t
    wg, dwgold, dwg = perturbed_state(solver.mesh, solver.device, solver.dtype)
    wa, dwa = alpha_states(wg, dwgold, dwg, scheme)
    wa_t, dwa_t = wa.T.contiguous(), dwa.T.contiguous()
    n, nd, d0 = lctx.num_node, len(lctx.offsets), lctx.offsets.index(0)

    k1 = lambda: lat.residual_volume(lctx, wa_t, dwa_t, phys, scheme)
    p1 = lambda: lat.residual_volume_plain(lctx, wa_t, dwa_t, phys, scheme)
    err1 = compare("K1 F volume", k1, p1, TOL_K1)

    # K2 with the masked epilogue on the solver's own mask and facet band
    keep_pc = keep_pc_rows(mask_t, solver.dtype)
    add18 = diag_add_rows(mask_t, solver.dtype)
    band, lo = lat._masked_face_band(fctxs, wa, dwa, phys, scheme, nd, keep_pc)
    keep16, add16 = keep_pc[:16].contiguous(), add18[:16].contiguous()
    k2 = lambda: lat.jacobian_volume(lctx, wa_t, phys, scheme, keep16, add16, band, lo)
    p2 = lambda: lat.jacobian_volume_plain(lctx, wa_t, phys, scheme, keep16, add16, band, lo)
    err2 = compare("K2 data (masked)", k2, p2, TOL_K2)
    ones16 = torch.ones_like(keep16)
    zeros16 = torch.zeros_like(add16)
    raw = lambda f: (lambda: f(lctx, wa_t, phys, scheme, ones16, zeros16))
    err2 = max(err2, compare(
        "K2 data (unmasked)", raw(lat.jacobian_volume), raw(lat.jacobian_volume_plain), TOL_K2
    ))
    jm = lat.assemble_jacobian_t(lctx, fctxs, mask_t, wa, dwa, phys, scheme)
    scal_p = torch.zeros_like(jm.scal)
    scal_p[2 * d0 : 2 * d0 + 2] = lctx.mult * keep_pc[16:18] + add18[16:18]
    err2 = max(err2, compare("K2 scal", lambda: jm.scal, lambda: scal_p, 0.0))

    gen = torch.Generator(device=solver.device).manual_seed(SEED)
    x = torch.randn((6, n), generator=gen, device=solver.device, dtype=solver.dtype)
    k3 = lambda: dia_matvec(jm.data, jm.scal, x, lctx.offsets)
    p3 = lambda: dia_matvec_plain(jm.data, jm.scal, x, lctx.offsets)
    err3 = compare("K3 A x (masked)", k3, p3, TOL_K3)
    # unmasked data, zero phi/T rows: only element entries set the scale
    raw_data, no_scal = raw(lat.jacobian_volume)(), torch.zeros_like(jm.scal)
    err3 = max(err3, compare(
        "K3 A x (unmasked)",
        lambda: dia_matvec(raw_data, no_scal, x, lctx.offsets),
        lambda: dia_matvec_plain(raw_data, no_scal, x, lctx.offsets), TOL_K3,
    ))
    del raw_data, no_scal
    results = [[err1], [err2], [err3]]

    for r, (name, _, _), (kern, plain, reps) in zip(
        results, KERNELS, ((k1, p1, 20), (k2, p2, 10), (k3, p3, 100))
    ):
        r += alternate_ms(kern, plain, reps, max(reps // 4, 3))
        say(f"  {name}: ms={r[1]:.4f} plain_ms={r[2]:.4f}")
    f_ms = cuda_ms(
        lambda: lat.assemble_residual_t(lctx, fctxs, mask_t, wa, dwa, phys, scheme), 10
    )
    j_ms = cuda_ms(
        lambda: lat.assemble_jacobian_t(lctx, fctxs, mask_t, wa, dwa, phys, scheme), 5
    )
    pc = NSFieldSplitPCT.from_diag_rows(jm.diag_rows())
    f = lat.assemble_residual_t(lctx, fctxs, mask_t, wa, dwa, phys, scheme)
    gmres120 = lambda: gmres(jm.matvec_t, f, maxit=120, atol=0.0, rtol=0.0, pc=pc)
    gmres120()  # warm-up: the first call initialises cuBLAS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = gmres120()
    torch.cuda.synchronize()
    times = {"F_ms": f_ms, "J_ms": j_ms, "SpMV_ms": results[2][1],
             "GMRES120_s": time.perf_counter() - t0, "GMRES120_iters": sol.iters}
    return results, times


def phase_slice() -> None:
    import torch

    from dedflow_tpu_torch.app.scenarios import reference_scenario_config
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.solver.newton import NSSolver

    mesh = box_mesh(*SLICE_BOX)
    cfg = reference_scenario_config()
    outs = []
    for device in ("cuda", "cpu"):
        solver = NSSolver(mesh, cfg, device=device)
        state = perturbed_state(mesh, device, solver.dtype)
        outs.append([t.cpu() for t in solver.step_fixed(*state, num_newton=2)])
    worst = 0.0
    for name, g, r in zip(("wgold", "dwgold", "dwg"), *outs):
        if not bool(torch.isfinite(g).all()):
            raise PhaseError(f"slice: non-finite {name} on the card")
        _, rel = rel_err(g, r)
        say(f"  {name}: card f32 vs cpu f64 rel={rel:.3e}")
        worst = max(worst, rel)
    check("slice", worst, TOL_SLICE)


def phase_main(solver) -> dict:
    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.sparse.dia_kernels import dia_matvec

    return drive_main(solver, (lat.residual_volume, lat.jacobian_volume, dia_matvec), "K1/K2/K3")


def phase_irregular_main(solver) -> dict:
    from dedflow_tpu_torch.fem import element_kernels as ek
    from dedflow_tpu_torch.sparse.win_kernels import winell_matvec
    from dedflow_tpu_torch.sparse.win_ring import ring_reduce
    from dedflow_tpu_torch.sparse.win_stream import stream_reduce

    counters = (ek.res_rows_call, ek.lhs_rows_call, winell_matvec, stream_reduce, ring_reduce)
    return drive_main(solver, counters, "K6res/K6lhs/K7/K8/K9")


def irregular_solver():
    """NSSolver on the RCM-ordered Delaunay mesh, with the host set-up
    seconds of each part."""
    import torch

    from dedflow_tpu_torch.app.scenarios import reference_scenario_config
    from dedflow_tpu_torch.mesh.gen import delaunay_mesh
    from dedflow_tpu_torch.mesh.reorder import rcm_order, reorder_mesh
    from dedflow_tpu_torch.solver.newton import NSSolver

    t0 = time.perf_counter()
    mesh = delaunay_mesh(DELAUNAY_POINTS, seed=SEED)
    t1 = time.perf_counter()
    mesh = reorder_mesh(mesh, rcm_order(mesh.ien, mesh.num_node))
    t2 = time.perf_counter()
    cfg = reference_scenario_config(bcs=(), pin_pressure=True)
    solver = NSSolver(mesh, cfg, device="cuda")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    setup = {"delaunay_s": t1 - t0, "rcm_s": t2 - t1, "solver_s": t3 - t2}
    if solver.fastpath != "winell":
        raise PhaseError(f"irregular: fastpath {solver.fastpath!r}, expected 'winell'")
    return solver, setup


def phase_irregular_kernels(solver) -> tuple[list, dict]:
    """K6 (residual, jacobian), K7, K8 and K9 against their plain versions
    at the solver's size; per kernel [max_abs_err, ms, plain_ms] and the
    system timings. Rows whose scales differ by orders of magnitude are
    checked separately: the element Jacobian and its entry sums per
    velocity/pressure block (the phi/T identities are exact), the products
    and residuals per equation."""
    import torch

    from dedflow_tpu_torch.fem import element_kernels as ek
    from dedflow_tpu_torch.fem import element_rows as er
    from dedflow_tpu_torch.fem import win_assembly as wa_
    from dedflow_tpu_torch.fem.element_rows import alpha_states
    from dedflow_tpu_torch.solver.krylov import gmres
    from dedflow_tpu_torch.solver.newton import assemble_system, residual
    from dedflow_tpu_torch.sparse.win_kernels import winell_matvec, winell_matvec_plain
    from dedflow_tpu_torch.sparse.win_ring import ring_reduce, ring_reduce_plain
    from dedflow_tpu_torch.sparse.win_stream import stream_reduce, stream_reduce_plain
    from dedflow_tpu_torch.sparse.winell import COMP2WIN

    phys, scheme = solver.cfg.physics, solver.cfg.time
    ctx, ne = solver.wctx, solver.wctx.num_elem
    wg, dwgold, dwg = perturbed_state(solver.mesh, solver.device, solver.dtype)
    wa, dwa = alpha_states(wg, dwgold, dwg, scheme)
    inp67 = wa_.residual_inputs(ctx, wa, dwa)
    inp27 = wa_.jacobian_inputs(ctx, wa)
    rargs, largs = ek.res_args(phys, scheme), ek.lhs_args(phys, scheme)
    by_eq = {" [u rows]": lambda t: t[:3], " [p row]": lambda t: t[3:4],
             " [phi,T rows]": lambda t: t[4:]}
    # the element Jacobian (rows ab*18+c) and its entry sums (WinELL rows)
    # per vel/p block, each against its own scale
    lhs_blocks = {f" [{b}]": (lambda t, c=list(cs): t.reshape(16, 18, ne)[:, c])
                  for b, cs in VP_BLOCKS.items()}
    lhs_blocks[" [phi,T identities]"] = lambda t: t.reshape(16, 18, ne)[:, 16:]
    entry_blocks = {f" [{b}]": (lambda t, r=[int(COMP2WIN[c]) for c in cs]: t[r])
                    for b, cs in VP_BLOCKS.items()}

    k6r = lambda: ek.res_rows_call(inp67, phys, scheme)
    p6r = lambda: er.res_rows(inp67, **rargs)
    e6r = compare("K6 res rows", k6r, p6r, TOL_K6)
    k6j = lambda: ek.lhs_rows_call(inp27, phys, scheme)
    p6j = lambda: er.lhs_rows(inp27, **largs)
    e6j = compare("K6 lhs rows", k6j, p6j, TOL_K6, parts=lhs_blocks)
    out24, out288 = k6r(), k6j()

    k8 = lambda: stream_reduce(ctx.res_plan, out24, range(6), ne)
    p8 = lambda: stream_reduce_plain(ctx.res_plan, out24, range(6), ne)
    e8 = compare("K8 residual node reduce", k8, p8, TOL_K8, parts=by_eq)
    comps = wa_.JAC_COMPS
    k9 = lambda: ring_reduce(ctx.jac_plan, out288, comps, ne)
    p9 = lambda: ring_reduce_plain(ctx.jac_plan, out288, comps, ne)
    e9 = compare("K9 jacobian entry reduce", k9, p9, TOL_K9, parts=entry_blocks)

    jm, pc = assemble_system(ctx, solver.face_ctxs, solver.mask_t, wg, dwgold, dwg, phys, scheme)
    gen = torch.Generator(device=solver.device).manual_seed(SEED)
    x = torch.randn((6, ctx.num_node), generator=gen, device=solver.device, dtype=solver.dtype)
    k7 = lambda: winell_matvec(jm, x)
    p7 = lambda: winell_matvec_plain(jm, x)
    e7 = compare("K7 A x", k7, p7, TOL_K7, parts=by_eq)

    results = [[e6r], [e6j], [e7], [e8], [e9]]
    for r, (name, _, _), (kern, plain, reps) in zip(
        results, IRREGULAR_KERNELS,
        ((k6r, p6r, 20), (k6j, p6j, 10), (k7, p7, 100), (k8, p8, 50), (k9, p9, 20)),
    ):
        r += alternate_ms(kern, plain, reps, max(reps // 10, 3))
        say(f"  {name}: ms={r[1]:.4f} plain_ms={r[2]:.4f}")
    common = (ctx, solver.face_ctxs, solver.mask_t, wg, dwgold, dwg, phys, scheme)
    f_ms = cuda_ms(lambda: residual(*common, solver.cfg.freeze_phi_temperature), 10)
    j_ms = cuda_ms(lambda: assemble_system(*common), 5)
    f = residual(*common, solver.cfg.freeze_phi_temperature)
    gmres120 = lambda: gmres(jm.matvec_t, f, maxit=120, atol=0.0, rtol=0.0, pc=pc)
    gmres120()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = gmres120()
    torch.cuda.synchronize()
    times = {"F_ms": f_ms, "J_ms": j_ms, "SpMV_ms": results[2][1],
             "GMRES120_s": time.perf_counter() - t0, "GMRES120_iters": sol.iters}
    return results, times


def phase_irregular_slice() -> None:
    """The converted box: card float32 (kernels) against CPU float64
    (plain versions), one step_fixed(num_newton=2), TOL_SLICE."""
    import dataclasses

    import torch

    from dedflow_tpu_torch.app.scenarios import reference_scenario_config
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.mesh.reorder import rcm_order, reorder_mesh
    from dedflow_tpu_torch.solver.newton import NSSolver

    mesh = dataclasses.replace(box_mesh(*SLICE_BOX), lattice=None)
    mesh = reorder_mesh(mesh, rcm_order(mesh.ien, mesh.num_node))
    cfg = reference_scenario_config(use_lattice="winell")
    outs = []
    for device in ("cuda", "cpu"):
        solver = NSSolver(mesh, cfg, device=device)
        if solver.fastpath != "winell" or not solver.face_ctxs:
            raise PhaseError("irregular slice: not on the winell tier with facets")
        state = perturbed_state(mesh, device, solver.dtype)
        outs.append([t.cpu() for t in solver.step_fixed(*state, num_newton=2)])
    worst = 0.0
    for name, g, r in zip(("wgold", "dwgold", "dwg"), *outs):
        if not bool(torch.isfinite(g).all()):
            raise PhaseError(f"irregular slice: non-finite {name} on the card")
        _, rel = rel_err(g, r)
        say(f"  {name}: card f32 vs cpu f64 rel={rel:.3e}")
        worst = max(worst, rel)
    check("irregular slice", worst, TOL_SLICE)


def drive_main(solver, counters, label: str) -> dict:
    """The main path: `solver.step` twice from the reference initial state
    with every launch counter set to 0 just before and read just after,
    then the first step repeated (bit-identical states and Krylov counts)."""
    import torch

    from dedflow_tpu_torch.app.scenarios import reference_initial_state
    from dedflow_tpu_torch.interop import state_from_numpy

    state0 = state_from_numpy(
        *reference_initial_state(solver.mesh), solver.device, solver.dtype
    )
    state, first = state0, None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    steps = []
    for step in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        *state, stats = solver.step(*state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        first = first or (state, stats.krylov_iters)
        norms = [float(v) for v in stats.rnorms[-1]]
        steps.append(wall)
        say(f"  step {step}: wall_s={wall:.4f} newton={len(stats.rnorms)} "
            f"krylov={stats.krylov_iters} converged={stats.converged} "
            f"field_norms={norms} launches {label} so far="
            f"{[c.launches for c in counters]}")
        if not all(map(math.isfinite, norms)):
            raise PhaseError(f"main: non-finite field norms at step {step}")
        if not all(bool(torch.isfinite(t).all()) for t in state):
            raise PhaseError(f"main: non-finite state at step {step}")
    launches = [c.launches for c in counters]
    peak = torch.cuda.max_memory_allocated()
    say(f"  launches {label} = {launches}; peak memory {peak / 2**30:.3f} GiB")
    if min(launches) <= 0:
        raise PhaseError(f"main: a kernel of the path was not launched: {launches}")
    *again, stats = solver.step(*state0)
    same = all(torch.equal(a, b) for a, b in zip(again, first[0]))
    say(f"  step 1 repeated: bit-identical states {same}, krylov {stats.krylov_iters}")
    if not same or stats.krylov_iters != first[1]:
        raise PhaseError("main: a repeated step differs from the first run")
    return {"launches": launches, "step_s": steps, "peak_bytes": peak}


def run() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    try:
        from dedflow_tpu_torch.app.scenarios import reference_scenario_config
        from dedflow_tpu_torch.mesh.gen import box_mesh
        from dedflow_tpu_torch.solver.newton import NSSolver
    except ImportError as e:
        print(f"FAIL: dedflow_tpu_torch not importable ({e})", file=sys.stderr)
        return 1
    phase = "1 card"
    try:
        card = card_line()
        say(f"phase 1 card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
        phase = "2 build"
        phase_build()
        phase = "3 kernels"
        t0 = time.perf_counter()
        solver = NSSolver(box_mesh(*FULL_BOX), reference_scenario_config(), device="cuda")
        say(f"phase 3 kernels at {solver.mesh.num_tet} tets, {solver.mesh.num_node} "
            f"nodes (setup {time.perf_counter() - t0:.1f} s)")
        results, times = phase_kernels(solver)
        say(f"  system: {json.dumps(times)}")
        phase = "4 slice"
        say(f"phase 4 slice at box {SLICE_BOX}")
        phase_slice()
        phase = "5 main"
        say(f"phase 5 main path at box {FULL_BOX}")
        main = phase_main(solver)
        del solver
        phase = "6 irregular kernels"
        solver, setup = irregular_solver()
        say(f"phase 6 irregular kernels at {solver.mesh.num_tet} Delaunay tets, "
            f"{solver.mesh.num_node} nodes, {solver.wctx.win_plan.S} matrix entries, "
            f"fastpath {solver.fastpath} (host setup s: {json.dumps(setup)})")
        ir_results, ir_times = phase_irregular_kernels(solver)
        say(f"  system: {json.dumps(ir_times)}")
        phase = "7 irregular slice"
        say(f"phase 7 irregular slice at the converted box {SLICE_BOX}")
        phase_irregular_slice()
        phase = "8 irregular main"
        say(f"phase 8 irregular main path at {solver.mesh.num_tet} Delaunay tets")
        ir_main = phase_irregular_main(solver)
    except Exception as e:  # report the failed phase, then fail
        traceback.print_exc()
        print(f"FAIL phase {phase}: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": n, "max_abs_err": r[0], "ms": r[1], "plain_ms": r[2]}
        for (name, src, rep), r, n in zip(
            KERNELS + IRREGULAR_KERNELS, results + ir_results,
            main["launches"] + ir_main["launches"],
        )
    ]
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
