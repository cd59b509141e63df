"""Mixed-precision iterative refinement around GMRES (counterpart of
dedflow_tpu/solver/refine.py).

BASELINE.md's correctness bar is a 1e-10 relative linear residual, which a
float32 GMRES cannot reach (unit roundoff ~6e-8). Classic iterative
refinement keeps the Krylov work in float32 and only one residual and one
update a cycle in float64:

    x = 0
    repeat: r = b - A64 x        (float64: K3 / K7's double instance)
            d = GMRES32(A32, r)  (float32: all the Krylov iterations)
            x = x + d            (float64)

Each cycle multiplies the residual by the float32 solve's convergence
factor, so a few cycles reach 1e-10, down to the float64 limit of the
assembled operator. The JAX package runs the outer loop as a
`lax.while_loop` on the device (`gmres_ir_device`); here it is a host loop
that reads the relative residual once a cycle, the loop's only sync
besides GMRES's own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from dedflow_tpu_torch.solver.krylov import gmres


@dataclass
class RefineInfo:
    x: torch.Tensor  # float64 solution
    rel_residual: float  # final ||b - A x|| / ||b||
    cycles: int
    inner_iters: int


@dataclass
class RefineDeviceInfo:
    x: torch.Tensor  # float64 solution
    rel_residual: torch.Tensor  # final ||b - A x|| / ||b|| (0-d tensor)
    cycles: int
    inner_iters: int


def gmres_ir_device(
    matvec_hi: Callable,
    matvec_lo: Callable,
    b: torch.Tensor,
    *,
    pc: Callable | None = None,
    tol: float = 1e-10,
    max_cycles: int = 10,
    inner_maxit: int = 120,
    inner_rtol: float = 1e-6,
) -> RefineDeviceInfo:
    """The refinement of krylov.precision "ir" (refine.py:45-89 of the JAX
    package): cycles while the relative residual exceeds `tol`, at most
    `max_cycles`; the inner solves are float32 GMRES(inner_maxit) with the
    float32 preconditioner `pc`, stopped at `inner_rtol`."""
    bnorm = torch.linalg.vector_norm(b.reshape(-1))
    eps = torch.finfo(b.dtype).tiny
    x = torch.zeros_like(b)
    rel_t = (bnorm > 0).to(b.dtype)
    rel, cycles, iters = float(rel_t), 0, 0
    while rel > tol and cycles < max_cycles:
        r = b - matvec_hi(x)
        sol = gmres(matvec_lo, r.to(torch.float32), maxit=inner_maxit, atol=0.0,
                    rtol=inner_rtol, pc=pc)
        x = x + sol.x.to(b.dtype)
        rel_t = torch.linalg.vector_norm((b - matvec_hi(x)).reshape(-1)) / torch.clamp(bnorm, min=eps)
        rel = float(rel_t)  # one host sync a cycle
        cycles += 1
        iters += sol.iters
    return RefineDeviceInfo(x=x, rel_residual=rel_t, cycles=cycles, inner_iters=iters)


def gmres_ir(
    matvec_hi: Callable,
    matvec_lo: Callable,
    b: torch.Tensor,
    *,
    pc: Callable | None = None,
    tol: float = 1e-10,
    max_cycles: int = 10,
    inner_maxit: int = 120,
    inner_rtol: float = 1e-6,
) -> RefineInfo:
    """The host-stepped variant (refine.py:92-136 of the JAX package): the
    residual is read before each cycle, so a solve already at `tol` takes
    no inner iteration and `cycles` counts the inner solves."""
    x = torch.zeros_like(b)
    bnorm = float(torch.linalg.vector_norm(b.reshape(-1)))
    if bnorm == 0.0:
        return RefineInfo(x=x, rel_residual=0.0, cycles=0, inner_iters=0)
    total_inner, cycles = 0, 0
    for cycles in range(1, max_cycles + 1):
        r = b - matvec_hi(x)
        rel = float(torch.linalg.vector_norm(r.reshape(-1))) / bnorm
        if rel <= tol:
            return RefineInfo(x=x, rel_residual=rel, cycles=cycles - 1, inner_iters=total_inner)
        sol = gmres(matvec_lo, r.to(torch.float32), maxit=inner_maxit, atol=0.0,
                    rtol=inner_rtol, pc=pc)
        total_inner += int(sol.iters)
        x = x + sol.x.to(b.dtype)
    rel = float(torch.linalg.vector_norm((b - matvec_hi(x)).reshape(-1))) / bnorm
    return RefineInfo(x=x, rel_residual=rel, cycles=cycles, inner_iters=total_inner)
