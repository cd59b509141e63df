"""Configuration dataclasses (+ JSON (de)serialization); a copy of
dedflow_tpu/config.py, kept field-for-field equal (tests/test_torch_policy.py).

The reference has no runtime configuration at all: physics and time
constants are compile-time #defines duplicated between main.c:23-29 and
assemble.cu:23-40 (and must be kept in sync by hand), BCs are hard-coded
in main (main.c:454-477), and `Init(argc, argv)` ignores argv
(common.c:21). This module is the idiomatic replacement (SURVEY.md
section 5, config/flag system).

Defaults reproduce the reference scenario exactly.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Laser:
    """Moving Gaussian heat source q(x, t) for DED melt-pool runs
    (BASELINE config #3; the reference has no source machinery - its T
    equation is frozen at main.c:64). The volumetric Gaussian integrates
    to `power`: q = P (2/pi)^1.5 / r^3 exp(-2 |x - c(t)|^2 / r^2) with
    c(t) = start + velocity * t."""

    power: float = 1.0
    radius: float = 0.1
    velocity: tuple[float, float, float] = (1.0, 0.0, 0.0)
    start: tuple[float, float, float] = (0.0, 0.5, 1.0)


@dataclass(frozen=True)
class Physics:
    """Material constants (assemble.cu:35-42)."""

    rho: float = 1.0e3  # kRHO
    mu: float = 10.0 / 3.0  # kMU
    cp: float = 1.0  # kCP
    kappa: float = 0.66  # kKAPPA
    body_force: tuple[float, float, float] = (0.0, 0.0, 0.0)  # fb (gravity off)
    laser: Laser | None = None


@dataclass(frozen=True)
class TimeScheme:
    """Generalized-alpha (main.c:23-27): rho_inf = kRHOC = 0.5."""

    dt: float = 5e-2  # kDT
    rho_inf: float = 0.5  # kRHOC

    @property
    def alpha_m(self) -> float:
        return (3.0 - self.rho_inf) / (1.0 + self.rho_inf)  # kALPHAM

    @property
    def alpha_f(self) -> float:
        return 1.0 / (1.0 + self.rho_inf)  # kALPHAF

    @property
    def gamma(self) -> float:
        return 0.5 + self.alpha_m - self.alpha_f  # kGAMMA

    @property
    def fact_dw(self) -> float:
        """d(dw_alpha)/d(dwg) = alpha_m (fact1, main.c:95)."""
        return self.alpha_m

    @property
    def fact_w(self) -> float:
        """d(w_alpha)/d(dwg) = dt*alpha_f*gamma (fact2, main.c:96-97)."""
        return self.dt * self.alpha_f * self.gamma


@dataclass(frozen=True)
class NewtonConfig:
    """main.c:83-89. `atol` is an absolute per-field floor the reference
    lacks (with atol=0 the semantics are identical): a field whose initial
    residual is exactly zero - e.g. continuity for a uniform initial flow -
    makes the relative test unattainable and the reference then always
    runs all 4 iterations.

    `lag_jacobian` (modified Newton): assemble J + preconditioner once per
    time step and reuse them for every Newton iteration. The Jacobian is
    already an inexact Picard tangent, so lagging trades a little
    convergence rate for skipping (max_iter-1) assemblies per step.
    Default off = reference semantics (reassemble every iteration,
    main.c:160)."""

    max_iter: int = 4
    rtol: float = 0.5e-3
    atol: float = 0.0
    lag_jacobian: bool = False


@dataclass(frozen=True)
class KrylovConfig:
    """main.c:406. The NS system is nonsymmetric, so the coupled solver
    always uses GMRES; solver.krylov.cg exists for SPD scalar problems
    (heat/Poisson - the reference's CG is an empty stub, krylov.c:42).
    `restart` = GMRES(m): None reproduces the reference's restart-free
    full-basis solve; small m cuts the per-iteration basis streaming on
    TPU at the cost of extra iterations."""

    solver: str = "gmres"
    max_iter: int = 120
    atol: float = 1e-12
    rtol: float = 1e-4
    restart: int | None = None
    # Preconditioner: "fieldsplit" = the reference's block-Jacobi
    # decomposition (krylov.c:440-452); "simple" = SIMPLE-type pressure
    # Schur complement (solver.pc.SIMPLEPC/SIMPLEPCT on the general/
    # lattice paths; ~2.5x fewer GMRES iterations on the cavity
    # benchmark at the same converged residuals); "mg" = SIMPLE with a
    # geometric-multigrid Schur solve (solver.mg.MGSIMPLEPCT, lattice
    # path - the AMG-class option the reference delegates to AmgX,
    # pc.c:160-235).
    pc: str = "fieldsplit"
    # damped-Jacobi sweeps of the approximate Schur solve (pc="simple")
    pc_schur_sweeps: int = 6
    pc_schur_omega: float = 0.8
    # V-cycle-preconditioned Richardson iterations of the Schur solve
    # (pc="mg")
    pc_mg_outer: int = 2
    # Linear-solve precision (the reference is f64 end to end,
    # common.h:21-59):
    #   "state" - solve in the state dtype (f32 TPU fast path; f64 when
    #             the run itself is f64) - round-1/2 behavior;
    #   "f64"   - force the whole Krylov solve to f64 (XLA-emulated on
    #             TPU) regardless of state dtype;
    #   "ir"    - mixed-precision iterative refinement: f32 GMRES inner
    #             solves + f64 residual/axpy (solver.refine), reaching
    #             <=1e-10 relative linear residuals at near-f32 cost.
    # "f64"/"ir" require jax_enable_x64 (the CLI --precision flag sets it).
    precision: str = "state"
    # iterative-refinement outer controls (precision="ir"): outer cycles
    # cap and the f32 inner-solve relative tolerance
    ir_cycles: int = 10
    ir_tol: float = 1e-10
    ir_inner_rtol: float = 1e-6


@dataclass(frozen=True)
class BCSpec:
    """Declarative BC: strong components and/or weak (Nitsche) flag for one
    boundary (generalizing main.c:454-477 + the hard-coded weak boundary 4,
    assemble.cu:1827)."""

    boundary: int
    strong_components: tuple[int, ...] = ()
    weak: bool = False


@dataclass(frozen=True)
class SolverConfig:
    physics: Physics = field(default_factory=Physics)
    time: TimeScheme = field(default_factory=TimeScheme)
    newton: NewtonConfig = field(default_factory=NewtonConfig)
    krylov: KrylovConfig = field(default_factory=KrylovConfig)
    bcs: tuple[BCSpec, ...] = ()
    num_steps: int = 4000  # main.c:331
    save_every: int = 10  # main.c:571
    freeze_phi_temperature: bool = True  # main.c:64 zeroes phi/T rows
    # Elements per streaming-assembly chunk (None = whole-mesh). Large
    # meshes need this on TPU: it bounds the element-Jacobian temp to
    # chunk*16*36 values (the XLA analogue of the reference's color-batch
    # loop, assemble.cu:1559).
    assembly_chunk: int | None = None
    # "segment" (exact sorted segment-sum; CPU oracle + sharded path) or
    # "prefix" (permute+cumsum+boundary-diff; ~4x faster on TPU where XLA
    # scatter is far off the HBM roofline, at ~1e-6 reduction reordering).
    scatter_method: str = "segment"
    # Replace the frozen-identity phi/T Jacobian blocks with consistent
    # transport tangents (weakform.scalar_lhs_blocks). Required whenever
    # freeze_phi_temperature=False (melt-pool/level-set runs).
    implicit_scalars: bool = False
    # "xla" or "pallas": the fused single-pass TPU element-Jacobian kernel
    # (fem.pallas_kernels; frozen-scalar mode only, else falls back).
    elements_kernel: str = "xla"
    # Constrain the pressure at node 0 (unit diagonal row). Needed for
    # fully enclosed flows (lid-driven cavity) whose pressure is only
    # defined up to a constant.
    pin_pressure: bool = False
    # Gather-free structured fast path (fem.lattice) on box_mesh lattices:
    # Structured fast-path mode ladder. "auto": generator metadata
    # (mesh.lattice) when present, else translation-class detection from
    # the connectivity alone (fem.lattice.build_class_context - this is
    # how converted/unstructured-format meshes enter the fast path);
    # "off": metadata-blind, class detection only; "gather": force the
    # fully general gather path (the oracle); "on": require a fast path.
    # Measured ~10-25x assembly+SpMV speedup on TPU (static shifted
    # slices vs gathers). Whole-mesh frozen-scalar runs only.
    # "winell": force the windowed irregular path (fem.win_assembly) -
    # for RCM-reordered Delaunay-class meshes; "auto" also reaches it
    # when class detection fails and the mesh order is locality-good.
    use_lattice: str = "auto"
    # Lattice element-kernel backend override: None = auto (fused Pallas
    # on TPU, XLA elsewhere); "xla" forces the dtype-generic XLA pipeline
    # (debugging / conservative compile environments).
    lattice_backend: str | None = None
    # WinELL Jacobian scatter variant: "pull" (degree-tiered per-entry
    # row gathers) or "segment"/"stream" (diagnostics)
    win_jac_scatter: str = "ring"


def reference_bcs() -> tuple[BCSpec, ...]:
    """The reference scenario's BCs (main.c:454-477, assemble.cu:1827):
    boundary 0: u fixed (inflow); 2: u_y = 0; 3: u_z = 0;
    4: no strong velocity BC + weak/Nitsche boundary terms."""
    return (
        BCSpec(boundary=0, strong_components=(0, 1, 2)),
        BCSpec(boundary=2, strong_components=(1,)),
        BCSpec(boundary=3, strong_components=(2,)),
        BCSpec(boundary=4, strong_components=(), weak=True),
    )


def _to_dict(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _to_dict(v) for k, v in dataclasses.asdict(obj).items()}
    return obj


def save_config(cfg: SolverConfig, path: str) -> None:
    with open(path, "w") as f:
        json.dump(_to_dict(cfg), f, indent=2)


def load_config(path: str) -> SolverConfig:
    with open(path) as f:
        return from_dict(json.load(f))


def from_dict(d: dict) -> SolverConfig:
    """SolverConfig from the `_to_dict` / JSON form (the schema
    load_config reads)."""
    phys_d = dict(d.get("physics", {}))
    phys_d["body_force"] = tuple(phys_d.get("body_force", (0.0, 0.0, 0.0)))
    laser_d = phys_d.get("laser")
    phys_d["laser"] = (
        Laser(
            power=laser_d.get("power", 1.0),
            radius=laser_d.get("radius", 0.1),
            velocity=tuple(laser_d.get("velocity", (1.0, 0.0, 0.0))),
            start=tuple(laser_d.get("start", (0.0, 0.5, 1.0))),
        )
        if laser_d
        else None
    )
    return SolverConfig(
        physics=Physics(**phys_d),
        time=TimeScheme(**d.get("time", {})),
        newton=NewtonConfig(
            max_iter=d.get("newton", {}).get("max_iter", 4),
            rtol=d.get("newton", {}).get("rtol", 0.5e-3),
            atol=d.get("newton", {}).get("atol", 0.0),
            lag_jacobian=d.get("newton", {}).get("lag_jacobian", False),
        ),
        krylov=KrylovConfig(
            **{**d.get("krylov", {}), "restart": d.get("krylov", {}).get("restart")}
        ),
        bcs=tuple(
            BCSpec(
                boundary=b["boundary"],
                strong_components=tuple(b.get("strong_components", ())),
                weak=b.get("weak", False),
            )
            for b in d.get("bcs", [])
        ),
        num_steps=d.get("num_steps", 4000),
        save_every=d.get("save_every", 10),
        freeze_phi_temperature=d.get("freeze_phi_temperature", True),
        assembly_chunk=d.get("assembly_chunk"),
        scatter_method=d.get("scatter_method", "segment"),
        implicit_scalars=d.get("implicit_scalars", False),
        elements_kernel=d.get("elements_kernel", "xla"),
        pin_pressure=d.get("pin_pressure", False),
        use_lattice=d.get("use_lattice", "auto"),
        win_jac_scatter=d.get("win_jac_scatter", "ring"),
        lattice_backend=d.get("lattice_backend"),
    )
