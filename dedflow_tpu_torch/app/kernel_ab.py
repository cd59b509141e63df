"""Time the lattice kernels K1 (residual, no source) and K2 (Jacobian,
frozen-scalar mode, masked with the facet band) of the dedflow_tpu_torch
package found under ROOT, on the card, at box_mesh(55, 55, 55) with the
reference scenario and chip_smoke.py's perturbed state (seed 0); with
`--reduces` also the segmented reduces K8 (6 rows) and K9 (16 rows) on the
WinELL plans of delaunay_mesh(56**3) + RCM and on the gather tier's plans
of the same mesh in its generated order, over seeded random element rows
(about 50 s of host set-up on top); with `--dem` the DEM contact sweep K11
on the coupled scenario's grid (box 55, 100,000 particles) and on
bench.py's two DEM cases (chip_smoke.py's phase 9); with `--implicit` K2
in its implicit mode at box_mesh(44, 44, 44) with the melt-pool scenario
(masked with the facet band, chip_smoke.py's phase 15); with `--elements`
the element Jacobian bodies that share csrc/element_body.cuh with K2: K6
(27-row frozen and 33-row implicit) on the box-55 lattice's element
inputs and K5 (frozen and implicit) on the gather tier of the same mesh
(998,250 tets in generated order); with `--jpath` each irregular tier's
Jacobian entry function as the solver calls it, frozen and implicit, on
delaunay_mesh(56**3): `fem.win_assembly.jacobian_win` on the RCM order
(K10, K6 and K9) and `fem.ns.jacobian_entries` on the generated order
(K5 and K9), whatever kernels each checkout runs inside them; with
`--rpath` the residual paths as the solvers call them: K1
(`lattice.residual_volume`) at box 44 with the melt-pool scenario and its
laser source (box 55 without one is the base run's "K1"), the gather
tier's volume residual `fem.ns.residual_volume` (K4 and K8, or the staged
K4 and K8's segment sum) on delaunay_mesh(56**3) in its generated order,
and the WinELL tier's `fem.win_assembly.residual_win` (K10, K6 and K8) on
its RCM order; with `--jpath` or `--rpath` also the WinELL tier's input
builders alone (`residual_inputs`, `jacobian_inputs`: K10 and whatever the
checkout does around it), the peak device memory one `residual_win` /
`jacobian_win` call allocates (`<name>_peak_bytes`); with `--steps` two
WinELL `NSSolver.step` from the reference initial state on
delaunay_mesh(56**3) + RCM and on box 55 with a hex over every cube
(chip_smoke.py's phases 8 and 23): the peak device memory, all
allocations counted (`<mesh>_steps_peak_bytes`), the wall seconds and a
digest of the state; with `--probes` K12's segment reduce
(`tools.gmicro.segment_reduce`) on the tool's (8, 2**23) stream at hb 16,
8, 4, 2 and 1, each with its relative error against the plain version
(`<name>_rel`; the kernel adds in an order that varies, so its digest
varies); with `--classes` K1c and K2c as the solver
calls them (`lattice.residual_volume` / `jacobian_volume`, whatever kernels
the checkout runs inside them) on the translation-class contexts of
chip_smoke.py's phase 20: box 55 deformed (the classes tier) and
shuffled, mirrored and recovered (the lattice tier with another split),
frozen, and K2c implicit on the deformed melt box 44 (about 15 s of host
set-up on top); with `--heat` the heat / Poisson slice at box 55
(chip_smoke.py's phase 22): the one-row K8 and K9 as the slice calls them
(`fem.assembly.scatter_residual` / `scatter_matrix` on seeded (ne, 4) and
(ne, 4, 4, 1, 1) element arrays, whatever each checkout runs inside
them), `torch.index_add` over the same contributions in the same sorted
order as the library yardstick (float32 atomics: its digest varies from
run to run), and one `fem.heat.assemble_poisson`, each also with the
peak device memory one call allocates (`<name>_peak_bytes`). A kernel whose
wrapper returns several tensors (K11's three forces, K2's data and scal)
is timed as the wrapper call, and its digest is of the tensors flattened
and concatenated.

    python dedflow_tpu_torch/app/kernel_ab.py --root CHECKOUT [--reps 5] [--reduces] [--dem]
        [--implicit] [--elements] [--jpath] [--rpath] [--classes] [--heat] [--probes] [--steps]

Two checkouts (say a parent commit unpacked beside the working tree) are
compared on one card by running this once per checkout, in turns: parent,
change, change, parent. Each run builds that checkout's kernels, imports
only that checkout's package, and prints one JSON line: the root, the card
(`nvidia-smi` name and power limit) and, per kernel, the median CUDA-event
time of `reps` blocks of launches after warm-up. The clock and the card
line are this script's own checkout's (tools/timing.py, loaded by path, so
that any ROOT can be timed by the same clock). Each kernel's output also
gets a digest (the first 16 hex digits of the SHA-256 of its bytes), so
that two checkouts' results can be compared bit for bit.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import sys
from pathlib import Path


def _timing():
    """tools/timing.py of the checkout this script is in."""
    path = Path(__file__).resolve().parents[1] / "tools" / "timing.py"
    spec = importlib.util.spec_from_file_location("_kernel_ab_timing", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # the dataclass looks its module up
    spec.loader.exec_module(mod)
    return mod


def _delaunay_solvers():
    """The WinELL solver of delaunay_mesh(56**3) + RCM and the gather
    tier's of the same mesh in its generated order (chip_smoke.py's phases
    6 and 12)."""
    from dedflow_tpu_torch.app.scenarios import reference_scenario_config
    from dedflow_tpu_torch.mesh.gen import delaunay_mesh
    from dedflow_tpu_torch.mesh.reorder import rcm_order, reorder_mesh
    from dedflow_tpu_torch.solver.newton import NSSolver

    raw = delaunay_mesh(56**3, seed=0)
    rcm = reorder_mesh(raw, rcm_order(raw.ien, raw.num_node))
    wsolver = NSSolver(rcm, reference_scenario_config(bcs=(), pin_pressure=True), device="cuda")
    gsolver = NSSolver(raw, reference_scenario_config(
        bcs=(), pin_pressure=True, scatter_method="tiered", elements_kernel="pallas"),
        device="cuda")
    if (wsolver.fastpath, gsolver.fastpath) != ("winell", "gather"):
        raise RuntimeError(f"tiers {wsolver.fastpath}, {gsolver.fastpath}: not winell, gather")
    return wsolver, gsolver


def _reduce_kernels(wsolver, gsolver):
    """{name: (call, reps)} of K8 and K9 on the WinELL and the gather plans
    of delaunay_mesh(56**3) (chip_smoke.py's phases 6 and 12)."""
    import torch

    from dedflow_tpu_torch.fem.win_assembly import JAC_COMPS
    from dedflow_tpu_torch.sparse.win_ring import ring_reduce
    from dedflow_tpu_torch.sparse.win_stream import stream_reduce

    wctx, gctx = wsolver.wctx, gsolver.gctx
    (grange,) = gctx.ranges
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for tier, ne, res_plan, jac_plan in (
        ("winell", wctx.num_elem, wctx.res_plan, wctx.jac_plan),
        ("gather", gctx.num_elem, grange.res_plan, grange.jac_plan),
    ):
        rows24 = torch.randn((24, ne), generator=gen, device="cuda")
        rows288 = torch.randn((288, ne), generator=gen, device="cuda")
        out[f"K8_{tier}"] = (lambda p=res_plan, x=rows24, m=ne: stream_reduce(p, x, range(6), m), 50)
        out[f"K9_{tier}"] = (lambda p=jac_plan, x=rows288, m=ne: ring_reduce(p, x, JAC_COMPS, m), 20)
    return out


def _alpha(solver):
    """The alpha states (N, 6) of the solver's mesh at the reference initial
    state with dwg perturbed as chip_smoke.py's (seed 0) and predicted."""
    import numpy as np
    import torch

    from dedflow_tpu_torch.app.scenarios import reference_initial_state
    from dedflow_tpu_torch.fem.element_rows import alpha_states
    from dedflow_tpu_torch.interop import state_from_numpy
    from dedflow_tpu_torch.solver.newton import predict

    wg, dwgold, dwg = reference_initial_state(solver.mesh)
    dwg = dwg + 0.1 * np.random.default_rng(0).standard_normal(dwg.shape)
    wg, dwgold, dwg = state_from_numpy(wg, dwgold, dwg, "cuda", torch.float32)
    return alpha_states(wg, dwgold, predict(dwg, solver.cfg.time), solver.cfg.time)


def _jacobian_paths(wsolver, gsolver):
    """{name: (call, reps)} of the irregular tiers' Jacobian entry
    functions, frozen and implicit, at seeded alpha states of each mesh
    (the reference initial state, dwg perturbed as chip_smoke.py's)."""
    from dedflow_tpu_torch.fem import ns
    from dedflow_tpu_torch.fem import win_assembly as wa_

    phys, scheme = wsolver.cfg.physics, wsolver.cfg.time
    wctx, gctx, wa_w, wa_g = wsolver.wctx, gsolver.gctx, _alpha(wsolver)[0], _alpha(gsolver)[0]
    out = {"J_winell_inputs": (lambda: wa_.jacobian_inputs(wctx, wa_w), 20)}
    for tag, implicit in (("", False), ("_implicit", True)):
        out[f"J_winell{tag}"] = (lambda i=implicit: wa_.jacobian_win(
            wctx, wa_w, phys, scheme, scalar_implicit=i).vals, 10)
        out[f"J_gather{tag}"] = (lambda i=implicit: ns.jacobian_entries(
            gctx, wa_g, phys, scheme, i), 10)
    return out


def _residual_paths(wsolver, gsolver):
    """{name: (call, reps)} of the irregular tiers' volume residuals as the
    solvers call them, at seeded alpha states of each mesh (the reference
    initial state, dwg perturbed as chip_smoke.py's): the gather tier's
    fem.ns.residual_volume and the WinELL tier's
    fem.win_assembly.residual_win."""
    from dedflow_tpu_torch.fem import ns
    from dedflow_tpu_torch.fem import win_assembly as wa_

    phys, scheme = wsolver.cfg.physics, wsolver.cfg.time
    (wa_w, dwa_w), (wa_g, dwa_g) = _alpha(wsolver), _alpha(gsolver)
    return {
        "F_gather": (lambda: ns.residual_volume(gsolver.gctx, wa_g, dwa_g, phys, scheme), 20),
        "F_winell": (lambda: wa_.residual_win(wsolver.wctx, wa_w, dwa_w, phys, scheme), 20),
        "F_winell_inputs": (lambda: wa_.residual_inputs(wsolver.wctx, wa_w, dwa_w), 20),
    }


def _winell_steps(wsolver) -> dict:
    """chip_smoke.py's phases 8 and 23 on the WinELL tier: two
    NSSolver.step from the reference initial state on the solver of
    delaunay_mesh(56**3) + RCM and on one of box 55 with a hex over every
    cube (mesh.gen.mixed_box_mesh); per mesh the device bytes allocated
    before the steps and at their peak (everything live counted), the
    steps' wall seconds and a digest of the state after them."""
    import time

    import torch

    from dedflow_tpu_torch.app.scenarios import reference_initial_state, reference_scenario_config
    from dedflow_tpu_torch.interop import state_from_numpy
    from dedflow_tpu_torch.mesh.gen import mixed_box_mesh
    from dedflow_tpu_torch.solver.newton import NSSolver

    out = {}
    for tag, make in (("delaunay", lambda: wsolver),
                      ("mixed", lambda: NSSolver(mixed_box_mesh(55, 55, 55),
                                                 reference_scenario_config(), device="cuda"))):
        solver = make()
        if solver.fastpath != "winell":
            raise RuntimeError(f"{tag}: tier {solver.fastpath}, not winell")
        state = state_from_numpy(*reference_initial_state(solver.mesh), "cuda", torch.float32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out[f"{tag}_steps_base_bytes"] = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        for _ in range(2):
            *state, _ = solver.step(*state)
        torch.cuda.synchronize()
        out[f"{tag}_steps_s"] = time.perf_counter() - t0
        out[f"{tag}_steps_peak_bytes"] = torch.cuda.max_memory_allocated()
        flat = torch.cat([t.reshape(-1) for t in state]).cpu()
        out[f"{tag}_steps_digest"] = hashlib.sha256(flat.numpy().tobytes()).hexdigest()[:16]
        del solver, state
    return out


def _probe_kernels():
    """{name: (call, reps)} of K12's segment reduce on tools/gmicro.py's
    (8, 2**23) stream at hb 16, 8, 4, 2, 1, and {name: relative error
    against the plain version}."""
    from dedflow_tpu_torch.tools import gmicro as tgm

    x, idx = tgm.inputs(1 << 23, "cuda")
    calls, rel = {}, {}
    for hb in (16, 8, 4, 2, 1):
        name = f"K12_reduce_hb{hb}"
        calls[name] = (lambda hb=hb: tgm.segment_reduce(x, idx, hb), 8)
        ref = tgm.segment_reduce_plain(x, idx, hb)
        rel[f"{name}_rel"] = float((tgm.segment_reduce(x, idx, hb) - ref).abs().max()
                                   / ref.abs().max())
    return calls, rel


def _melt_residual():
    """{name: (call, reps)} of K1 at box_mesh(44, 44, 44) with the
    melt-pool scenario and its laser source at step 1's generalized-alpha
    level (chip_smoke.py's phase 15)."""
    import numpy as np
    import torch

    from dedflow_tpu_torch.app.scenarios import (
        laser_source,
        melt_pool_initial_state,
        melt_pool_scenario_config,
    )
    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.fem.element_rows import alpha_states
    from dedflow_tpu_torch.interop import state_from_numpy
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.solver.newton import NSSolver, predict

    mesh, cfg = box_mesh(44, 44, 44), melt_pool_scenario_config()
    solver = NSSolver(mesh, cfg, device="cuda")
    wg, dwgold, dwg = melt_pool_initial_state(mesh)
    dwg = dwg + 0.1 * np.random.default_rng(0).standard_normal(dwg.shape)
    wg, dwgold, dwg = state_from_numpy(wg, dwgold, dwg, "cuda", torch.float32)
    wa, dwa = alpha_states(wg, dwgold, predict(dwg, cfg.time), cfg.time)
    src = torch.as_tensor(laser_source(cfg.physics.laser, mesh.xg, cfg.time.alpha_f * cfg.time.dt),
                          dtype=torch.float32, device="cuda")
    wa_t, dwa_t, lctx = wa.T.contiguous(), dwa.T.contiguous(), solver.lctx
    call = lambda: lat.residual_volume(lctx, wa_t, dwa_t, cfg.physics, cfg.time, src)
    return {"K1_source": (call, 20)}


def _dem_kernels():
    """{name: (call, reps)} of K11 on the coupled scenario's grid and on
    bench.py's uniform and settled-bed clouds (bench.py:512-592, the same
    draws as chip_smoke.py's phase 9)."""
    import dataclasses

    import numpy as np
    import torch

    from dedflow_tpu_torch.app.scenarios import coupled_scenario_setup
    from dedflow_tpu_torch.dem.cells import cell_stats, make_grid
    from dedflow_tpu_torch.dem.grid import grid_pair_forces_cuda, to_grid
    from dedflow_tpu_torch.dem.integrate import DEMConfig
    from dedflow_tpu_torch.dem.particles import particle_state
    from dedflow_tpu_torch.mesh.gen import box_mesh

    call = lambda grid, gs, prm: (lambda: grid_pair_forces_cuda(grid, gs, prm))
    ccfg, pst = coupled_scenario_setup(box_mesh(55, 55, 55), num_particles=100_000,
                                       device="cuda")
    grid = ccfg.dem.grid
    out = {"K11_coupled": (call(grid, to_grid(grid, pst, 100_000), ccfg.dem.contact), 20)}
    radius, p0 = 0.006, 100_000
    rng = np.random.RandomState(0)
    x_uni = rng.uniform(0.02, 0.98, size=(p0, 3)).astype(np.float32)
    s = radius * (4.0 * np.pi / (3.0 * 0.45)) ** (1.0 / 3.0)
    npx, ii = int(1.0 / s), np.arange(p0)
    g = np.stack([(ii % npx + 0.5) * s, ((ii // npx) % npx + 0.5) * s,
                  (ii // (npx * npx) + 0.5) * s], axis=1)
    jit = (rng.uniform(-0.08, 0.08, size=(p0, 3)) * s).astype(np.float32)
    x_bed = g.astype(np.float32) + jit
    for name, x in (("uniform_100k", x_uni), ("settled_bed_100k", x_bed)):
        probe = make_grid([0, 0, 0], (1, 1, 1), cell_size=2.5 * radius, capacity=2)
        cap = max(2, cell_stats(probe, x)["max_per_cell"] + 1)
        grid = dataclasses.replace(probe, capacity=cap)
        cfg = DEMConfig(grid=grid, dt=1e-5, walls_lo=(0, 0, 0), walls_hi=(1, 1, 1))
        st = particle_state(np.asarray(x, dtype=np.float64), radius=radius, mass=1.0,
                            device="cuda")
        out[f"K11_{name}"] = (call(grid, to_grid(grid, st, p0), cfg.contact), 20)
    return out


def _implicit_kernels():
    """{name: (call, reps)} of K2's implicit mode at box_mesh(44, 44, 44),
    melt-pool scenario, masked with the facet band (data and scal rows)."""
    import numpy as np
    import torch

    from dedflow_tpu_torch.app.scenarios import melt_pool_initial_state, melt_pool_scenario_config
    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.fem.element_rows import alpha_states
    from dedflow_tpu_torch.interop import state_from_numpy
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.solver.newton import NSSolver, predict
    from dedflow_tpu_torch.sparse.fsbsr import diag_add_rows, keep_pc_rows

    mesh, cfg = box_mesh(44, 44, 44), melt_pool_scenario_config()
    solver = NSSolver(mesh, cfg, device="cuda")
    if not solver.lctx.scalar_implicit:
        raise RuntimeError("melt solver: the lattice context is not implicit")
    wg, dwgold, dwg = melt_pool_initial_state(mesh)
    dwg = dwg + 0.1 * np.random.default_rng(0).standard_normal(dwg.shape)
    wg, dwgold, dwg = state_from_numpy(wg, dwgold, dwg, "cuda", torch.float32)
    wa, dwa = alpha_states(wg, dwgold, predict(dwg, cfg.time), cfg.time)
    phys, scheme, lctx = cfg.physics, cfg.time, solver.lctx
    keep = keep_pc_rows(solver.mask_t, torch.float32)
    add = diag_add_rows(solver.mask_t, torch.float32)
    band, lo = lat._masked_face_band(solver.face_ctxs, wa, dwa, phys, scheme,
                                     len(lctx.offsets), keep)
    wa_t = wa.T.contiguous()
    call = lambda: lat.jacobian_volume(lctx, wa_t, phys, scheme, keep, add, band, lo)
    return {"K2_implicit": (call, 10)}


def _class_kernels():
    """{name: (call, reps)} of K1c and K2c as the solver calls them
    (`lattice.residual_volume` / `jacobian_volume`, whatever kernels the
    checkout runs inside them) on chip_smoke.py's phase-20 contexts: box
    55 as (a) mesh.gen.deformed_mesh (the classes tier) and (b)
    shuffled_mesh(seed=1, mirror=True) through recover_lattice (the
    lattice tier with another split), frozen and masked with the facet
    band, and the implicit mode on the deformed melt box 44
    (melt_pool_scenario_config), at chip_smoke's perturbed states."""
    import numpy as np
    import torch

    from dedflow_tpu_torch.app.scenarios import (
        melt_pool_initial_state,
        melt_pool_scenario_config,
        reference_initial_state,
        reference_scenario_config,
    )
    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.fem.element_rows import alpha_states
    from dedflow_tpu_torch.interop import state_from_numpy
    from dedflow_tpu_torch.mesh.gen import box_mesh, deformed_mesh, shuffled_mesh
    from dedflow_tpu_torch.mesh.recover import recover_lattice
    from dedflow_tpu_torch.solver.newton import NSSolver, predict
    from dedflow_tpu_torch.sparse.fsbsr import diag_add_rows, keep_pc_rows

    box = box_mesh(55, 55, 55)
    melt_box = deformed_mesh(box_mesh(44, 44, 44))
    cases = (
        ("a", deformed_mesh(box), reference_scenario_config(), "classes"),
        ("b", recover_lattice(shuffled_mesh(box, seed=1, mirror=True))[0],
         reference_scenario_config(), "lattice"),
        ("melt", melt_box, melt_pool_scenario_config(), "classes"),
    )
    out = {}
    for tag, mesh, cfg, tier in cases:
        solver = NSSolver(mesh, cfg, device="cuda")
        lctx, phys, scheme = solver.lctx, cfg.physics, cfg.time
        if solver.fastpath != tier or lctx.fused is not None:
            raise RuntimeError(f"{tag}: tier {solver.fastpath}, fused {lctx.fused is not None}")
        implicit = cfg.implicit_scalars
        init = melt_pool_initial_state if implicit else reference_initial_state
        wg, dwgold, dwg = init(mesh)
        dwg = dwg + 0.1 * np.random.default_rng(0).standard_normal(dwg.shape)
        wg, dwgold, dwg = state_from_numpy(wg, dwgold, dwg, "cuda", torch.float32)
        wa, dwa = alpha_states(wg, dwgold, predict(dwg, scheme), scheme)
        wa_t, dwa_t = wa.T.contiguous(), dwa.T.contiguous()
        keep = keep_pc_rows(solver.mask_t, torch.float32)
        add = diag_add_rows(solver.mask_t, torch.float32)
        band, lo = lat._masked_face_band(solver.face_ctxs, wa, dwa, phys, scheme,
                                         len(lctx.offsets), keep)
        if not implicit:
            keep, add = keep[:16].contiguous(), add[:16].contiguous()
            out[f"K1c_{tag}"] = (lambda c=lctx, w=wa_t, d=dwa_t, p=phys, s=scheme:
                                 lat.residual_volume(c, w, d, p, s), 20)
        name = "K2c_implicit_melt" if implicit else f"K2c_{tag}"
        out[name] = (lambda c=lctx, w=wa_t, p=phys, s=scheme, k=keep, a=add, b=band, o=lo:
                     lat.jacobian_volume(c, w, p, s, k, a, b, o), 10)
    return out


def _heat_kernels():
    """{name: (call, reps)} of the heat / Poisson slice at box_mesh(55, 55,
    55) (chip_smoke.py's phase 22): the scalar scatters as assemble_poisson
    calls them on seeded element arrays, index_add over the same sorted
    contributions, and assemble_poisson with the phase's source."""
    import numpy as np
    import torch

    from dedflow_tpu_torch.fem.assembly import build_context, scatter_matrix, scatter_residual
    from dedflow_tpu_torch.fem.heat import assemble_poisson
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.sparse.topology import build_sparsity

    mesh = box_mesh(55, 55, 55)
    ctx = build_context(mesh, device="cuda", dtype=torch.float32, scalar_plans=True)
    ne, n = ctx.num_elem, mesh.num_node
    rng = np.random.default_rng(0)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    ef = as_t(rng.standard_normal((ne, 4)))
    ej = as_t(rng.standard_normal((ne, 4, 4, 1, 1)))
    x, y, z = mesh.xg.T
    f = as_t(3 * np.pi**2 * np.sin(np.pi * x) * np.sin(np.pi * y) * np.sin(np.pi * z))

    def index_add(targets, values, num_tgt):
        """torch.index_add of the contributions sorted stably by target:
        the plans' order."""
        flat = torch.as_tensor(np.asarray(targets).reshape(-1), dtype=torch.long, device="cuda")
        perm = torch.argsort(flat, stable=True)
        tgt, vals = flat[perm], values.reshape(-1)[perm]
        zeros = torch.zeros(num_tgt, dtype=torch.float32, device="cuda")
        return lambda: torch.index_add(zeros, 0, tgt, vals)

    nnz = build_sparsity(mesh.ien, n).elem_nnz
    return {
        "K8_heat": (lambda: scatter_residual(ctx, ef), 20),
        "K8_heat_index_add": (index_add(mesh.ien, ef, n), 20),
        "K9_heat": (lambda: scatter_matrix(ctx, ej), 20),
        "K9_heat_index_add": (index_add(nnz, ej, ctx.win_plan.S), 20),
        "assemble_poisson": (lambda: (lambda k, b: (k.data, b))(*assemble_poisson(ctx, f)), 10),
    }


def _peak_bytes(fn) -> int:
    """Device bytes one call allocates at its peak, above what was
    allocated before it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _element_kernels(mesh, lctx, wa, wa_t, phys, scheme):
    """{name: (call, reps)} of K6's Jacobian rows (27-row frozen, 33-row
    implicit: the lattice inputs with the metric rows of res_geom) at the
    lattice context `lctx`, and of K5 (frozen, implicit) on the gather
    tier of `mesh`, from the alpha states wa (N, 6) / wa_t (6, N)."""
    import torch

    from dedflow_tpu_torch.app.scenarios import reference_scenario_config
    from dedflow_tpu_torch.fem import element_kernels as ek
    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.solver.newton import NSSolver

    inp27 = lat._lhs_inputs(lctx, wa_t)
    inp33 = torch.cat([inp27, lctx.res_geom[:, 13:19]], dim=1).contiguous()
    gsolver = NSSolver(mesh, reference_scenario_config(use_lattice="gather"), device="cuda")
    if gsolver.fastpath != "gather":
        raise RuntimeError(f"tier {gsolver.fastpath}: not gather")
    ctx, w_t = gsolver.gctx, wa.T.contiguous()
    met = ctx.res_geom[13:19]
    return {
        "K6_jacobian": (lambda: ek.lhs_rows_call(inp27, phys, scheme), 10),
        "K6_33row": (lambda: ek.lhs_rows_call(inp33, phys, scheme, True), 10),
        "K5": (lambda: ek.ns_lhs_gather(ctx.lhs_geom, ctx.ien_t, w_t, phys, scheme), 10),
        "K5_implicit": (lambda: ek.ns_lhs_gather(ctx.lhs_geom, ctx.ien_t, w_t, phys, scheme, met),
                        10),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", required=True, help="checkout whose dedflow_tpu_torch is timed")
    p.add_argument("--reps", type=int, default=5, help="timed blocks per kernel")
    p.add_argument("--reduces", action="store_true",
                   help="also K8 and K9 on the WinELL and gather plans of delaunay_mesh(56**3)")
    p.add_argument("--dem", action="store_true",
                   help="also K11 on the coupled grid and bench.py's two DEM cases")
    p.add_argument("--implicit", action="store_true",
                   help="also K2's implicit mode at box 44 with the melt-pool scenario")
    p.add_argument("--elements", action="store_true",
                   help="also K6's and K5's element Jacobians (frozen, implicit) at box 55")
    p.add_argument("--jpath", action="store_true",
                   help="also the WinELL and gather tiers' Jacobian entry functions (frozen, "
                        "implicit) on delaunay_mesh(56**3)")
    p.add_argument("--classes", action="store_true",
                   help="also K1c and K2c through the solver's entries on chip_smoke.py's "
                        "phase-20 contexts (box 55 deformed and recovered; implicit on the "
                        "deformed melt box 44)")
    p.add_argument("--rpath", action="store_true",
                   help="also K1 at box 44 with the melt source and the gather and WinELL "
                        "tiers' volume residuals on delaunay_mesh(56**3)")
    p.add_argument("--heat", action="store_true",
                   help="also the heat / Poisson slice at box 55: the one-row K8 / K9 as "
                        "assemble_poisson calls them, index_add, assemble_poisson, peak memory")
    p.add_argument("--steps", action="store_true",
                   help="also two WinELL steps (chip_smoke.py's phases 8 and 23): peak memory, "
                        "wall s and a digest of the state")
    p.add_argument("--probes", action="store_true",
                   help="also K12's segment reduce on the tool's (8, 2**23) stream, hb 16-1")
    args = p.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import dedflow_tpu_torch
    from dedflow_tpu_torch.app.scenarios import reference_initial_state, reference_scenario_config
    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.fem.element_rows import alpha_states
    from dedflow_tpu_torch.interop import state_from_numpy
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.solver.newton import NSSolver, predict
    from dedflow_tpu_torch.sparse.fsbsr import diag_add_rows, keep_pc_rows

    if root not in Path(dedflow_tpu_torch.__file__).resolve().parents:
        raise RuntimeError(f"imported {dedflow_tpu_torch.__file__}, not the package under {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the kernels run only there")
    mesh = box_mesh(55, 55, 55)
    cfg = reference_scenario_config()
    solver = NSSolver(mesh, cfg, device="cuda")
    wg, dwgold, dwg = reference_initial_state(mesh)
    dwg = dwg + 0.1 * np.random.default_rng(0).standard_normal(dwg.shape)
    wg, dwgold, dwg = state_from_numpy(wg, dwgold, dwg, "cuda", torch.float32)
    wa, dwa = alpha_states(wg, dwgold, predict(dwg, cfg.time), cfg.time)
    wa_t, dwa_t = wa.T.contiguous(), dwa.T.contiguous()
    phys, scheme, lctx = cfg.physics, cfg.time, solver.lctx
    keep = keep_pc_rows(solver.mask_t, torch.float32)
    add = diag_add_rows(solver.mask_t, torch.float32)
    band, lo = lat._masked_face_band(solver.face_ctxs, wa, dwa, phys, scheme, len(lctx.offsets), keep)
    keep16, add16 = keep[:16].contiguous(), add[:16].contiguous()
    kernels = {
        "K1": (lambda: lat.residual_volume(lctx, wa_t, dwa_t, phys, scheme), 20),
        "K2": (lambda: lat.jacobian_volume(lctx, wa_t, phys, scheme, keep16, add16, band, lo), 10),
    }
    if args.reduces or args.jpath or args.rpath or args.steps:
        delaunay = _delaunay_solvers()
    if args.reduces:
        kernels.update(_reduce_kernels(*delaunay))
    if args.jpath:
        kernels.update(_jacobian_paths(*delaunay))
    if args.rpath:
        kernels.update(_melt_residual())
        kernels.update(_residual_paths(*delaunay))
    if args.dem:
        kernels.update(_dem_kernels())
    if args.implicit:
        kernels.update(_implicit_kernels())
    if args.elements:
        kernels.update(_element_kernels(mesh, lctx, wa, wa_t, phys, scheme))
    if args.classes:
        kernels.update(_class_kernels())
    heat = _heat_kernels() if args.heat else {}
    kernels.update(heat)
    checks = {}
    if args.probes:
        probe_calls, checks = _probe_kernels()
        kernels.update(probe_calls)
    peaks = set(heat) | {"F_winell", "J_winell", "J_winell_implicit"}
    timing = _timing()
    out = {"root": str(root)} | checks
    for name, (fn, n) in kernels.items():
        out[f"{name}_ms"] = timing.time_ms(fn, n, samples=args.reps)
        if name in peaks:
            out[f"{name}_peak_bytes"] = _peak_bytes(fn)
        got = fn()
        if isinstance(got, (list, tuple)):
            got = torch.cat([g.reshape(-1) for g in got])
        got = got.contiguous().cpu()
        out[f"{name}_digest"] = hashlib.sha256(got.numpy().tobytes()).hexdigest()[:16]
    if args.steps:
        del kernels, heat
        out.update(_winell_steps(delaunay[0]))
    out["card"] = timing.card_line()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
