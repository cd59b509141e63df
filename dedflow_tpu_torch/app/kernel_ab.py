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
(K5 and K9), whatever kernels each checkout runs inside them. A kernel whose
wrapper returns several tensors (K11's three forces, K2's data and scal)
is timed as the wrapper call, and its digest is of the tensors flattened
and concatenated.

    python dedflow_tpu_torch/app/kernel_ab.py --root CHECKOUT [--reps 5] [--reduces] [--dem]
        [--implicit] [--elements] [--jpath]

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


def _jacobian_paths(wsolver, gsolver):
    """{name: (call, reps)} of the irregular tiers' Jacobian entry
    functions, frozen and implicit, at seeded alpha states of each mesh
    (the reference initial state, dwg perturbed as chip_smoke.py's)."""
    import numpy as np
    import torch

    from dedflow_tpu_torch.app.scenarios import reference_initial_state
    from dedflow_tpu_torch.fem import ns
    from dedflow_tpu_torch.fem import win_assembly as wa_
    from dedflow_tpu_torch.fem.element_rows import alpha_states
    from dedflow_tpu_torch.interop import state_from_numpy
    from dedflow_tpu_torch.solver.newton import predict

    def alpha(solver):
        wg, dwgold, dwg = reference_initial_state(solver.mesh)
        dwg = dwg + 0.1 * np.random.default_rng(0).standard_normal(dwg.shape)
        wg, dwgold, dwg = state_from_numpy(wg, dwgold, dwg, "cuda", torch.float32)
        return alpha_states(wg, dwgold, predict(dwg, solver.cfg.time), solver.cfg.time)[0]

    phys, scheme = wsolver.cfg.physics, wsolver.cfg.time
    wctx, gctx, wa_w, wa_g = wsolver.wctx, gsolver.gctx, alpha(wsolver), alpha(gsolver)
    out = {}
    for tag, implicit in (("", False), ("_implicit", True)):
        out[f"J_winell{tag}"] = (lambda i=implicit: wa_.jacobian_win(
            wctx, wa_w, phys, scheme, scalar_implicit=i).vals, 10)
        out[f"J_gather{tag}"] = (lambda i=implicit: ns.jacobian_entries(
            gctx, wa_g, phys, scheme, i), 10)
    return out


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
    if args.reduces or args.jpath:
        delaunay = _delaunay_solvers()
    if args.reduces:
        kernels.update(_reduce_kernels(*delaunay))
    if args.jpath:
        kernels.update(_jacobian_paths(*delaunay))
    if args.dem:
        kernels.update(_dem_kernels())
    if args.implicit:
        kernels.update(_implicit_kernels())
    if args.elements:
        kernels.update(_element_kernels(mesh, lctx, wa, wa_t, phys, scheme))
    timing = _timing()
    out = {"root": str(root)}
    for name, (fn, n) in kernels.items():
        out[f"{name}_ms"] = timing.time_ms(fn, n, samples=args.reps)
        got = fn()
        if isinstance(got, (list, tuple)):
            got = torch.cat([g.reshape(-1) for g in got])
        got = got.contiguous().cpu()
        out[f"{name}_digest"] = hashlib.sha256(got.numpy().tobytes()).hexdigest()[:16]
    out["card"] = timing.card_line()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
