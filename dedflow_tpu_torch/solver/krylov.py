"""Right-preconditioned GMRES and preconditioned CG (counterpart of
dedflow_tpu/solver/krylov.py::gmres and ::cg).

Same algorithm as the JAX package, so float64 iterates agree to roundoff
and the iteration count is the same: Krylov dimension = maxit (or GMRES(m)
with `restart`), block modified Gram-Schmidt over 8-row blocks of the basis,
Givens rotations, and the stopping test |beta[it+1]| < max(atol,
(beta0 + 1e-16) * rtol) (krylov.c:281-290 of the reference).

The JAX solve is one `lax.while_loop` with the test on the device. In eager
PyTorch every read of the test is a host sync, so the loop here runs the
Arnoldi steps of one 8-row basis block without looking, then reads the
block's residual estimates once and takes the first converged iteration.
Steps run past convergence inside a block change nothing the solution
reads (columns and basis rows beyond it are never used). One solve makes
1 + ceil(iters / 8) host syncs, plus one per restart cycle with `restart`.

`cg` runs the JAX package's iterates and stopping test in blocks of
_CG_BLOCK iterations between host syncs (1 + ceil(iters / 8) a solve): an
iteration of a block that starts after convergence leaves x, r, p and rz
as they were (a torch.where on a device flag), so the iteration count is
the JAX loop's exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

_CGS_B = 8  # Gram-Schmidt block size (basis rows per block)
_CG_BLOCK = 8  # CG iterations between host syncs


@dataclass
class KrylovInfo:
    x: torch.Tensor
    iters: int  # iterations performed
    resnorm: torch.Tensor  # final (estimated) residual norm
    resnorm0: torch.Tensor  # initial residual norm
    converged: bool
    # GMRES: the estimated residual norm after each iteration (restart
    # cycles one after the other); None for CG
    rhist: torch.Tensor | None = None


def _givens_carry(cs, sn, h, it: int):
    """Apply the first `it` Givens rotations to the new Hessenberg column h
    (length maxit+1). The rotation chain carry_{i+1} = -s_i carry_i +
    c_i h_{i+1} is an affine recurrence; as in the JAX package it runs as
    a log-depth inclusive scan (Hillis-Steele here) instead of `it`
    sequential steps. Entries past `it` are untouched."""
    if it == 0:
        return h.clone()
    pa, pb = -sn[:it], cs[:it] * h[1 : it + 1]
    d = 1
    while d < it:
        # element i composed after element i - d:
        # (A, B) -> (A_i A_{i-d}, A_i B_{i-d} + B_i)
        pa, pb = (
            torch.cat([pa[:d], pa[d:] * pa[:-d]]),
            torch.cat([pb[:d], torch.addcmul(pb[d:], pa[d:], pb[:-d])]),
        )
        d *= 2
    carr = torch.cat([h[:1], pa * h[0] + pb])  # carry_0 .. carry_it
    head = cs[:it] * carr[:it] + sn[:it] * h[1 : it + 1]
    return torch.cat([head, carr[it:], h[it + 1 :]])


def gmres(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    maxit: int = 120,
    atol=1e-12,
    rtol: float = 1e-4,
    pc: Callable | None = None,
    restart: int | None = None,
    allreduce: Callable | None = None,
) -> KrylovInfo:
    """Solve A x = b; `pc` is the right preconditioner (approximate A^-1).
    `atol` may be a float or a 0-d tensor. `allreduce` (a rank's own rows
    of a distributed system, parallel.spmd.SlabComm.allreduce_sum) sums
    each inner product and squared norm over the ranks, so H, beta and
    every stop test are the same on every rank; None leaves the
    one-process arithmetic as it is."""
    if restart is not None and restart < maxit:
        return _gmres_restarted(
            matvec, b, x0, maxit=maxit, atol=atol, rtol=rtol, pc=pc, m=restart,
            allreduce=allreduce,
        )
    if pc is None:
        pc = lambda v: v
    if x0 is None:
        x0 = torch.zeros_like(b)
    shape, dtype, dev = b.shape, b.dtype, b.device
    n = b.numel()
    eps = torch.finfo(dtype).tiny

    red = allreduce or (lambda t: t)
    r0 = (b - matvec(x0)).reshape(-1)
    beta0 = _norm(r0, allreduce)
    tol = torch.maximum(
        torch.as_tensor(atol, dtype=dtype, device=dev), (beta0 + 1e-16) * rtol
    )

    nrows = (maxit + 1 + _CGS_B - 1) // _CGS_B * _CGS_B
    Q = torch.zeros((nrows, n), dtype=dtype, device=dev)
    Q[0] = r0 / torch.clamp(beta0, min=eps)
    H = torch.zeros((maxit, maxit), dtype=dtype, device=dev)
    cs = torch.zeros(maxit, dtype=dtype, device=dev)
    sn = torch.zeros(maxit, dtype=dtype, device=dev)
    beta = torch.zeros(maxit + 1, dtype=dtype, device=dev)
    beta[0] = beta0
    rhist = torch.zeros(maxit, dtype=dtype, device=dev)  # |beta[it+1]| at step it

    def arnoldi_step(it: int) -> None:
        w = matvec(pc(Q[it].reshape(shape))).reshape(-1)
        h = torch.zeros(nrows, dtype=dtype, device=dev)
        for bi in range(it // _CGS_B + 1):
            lo = bi * _CGS_B
            hi = min(lo + _CGS_B, it + 1)  # rows beyond `it` are masked to 0
            qb = Q[lo:hi]
            hb = red(qb @ w)
            w = w - qb.T @ hb
            h[lo:hi] = hb
        h = h[: maxit + 1]
        hnext = _norm(w, allreduce)
        Q[it + 1] = w / torch.clamp(hnext, min=eps)
        hcol = _givens_carry(cs, sn, h, it)
        hk = hcol[it]
        denom = torch.sqrt(hk * hk + hnext * hnext)
        safe = torch.clamp(denom, min=eps)
        pos = denom > 0
        c_new = torch.where(pos, hk / safe, torch.ones_like(hk))
        s_new = torch.where(pos, hnext / safe, torch.zeros_like(hk))
        hcol[it] = denom
        cs[it] = c_new
        sn[it] = s_new
        bi_ = beta[it].clone()
        beta[it + 1] = -s_new * bi_
        beta[it] = c_new * bi_
        H[:, it] = hcol[:maxit]
        rhist[it] = beta[it + 1].abs()

    it = 0
    done = bool(beta0 < tol)  # host sync
    while it < maxit and not done:
        start = it
        stop = min(maxit, (it // _CGS_B + 1) * _CGS_B)
        for j in range(start, stop):
            arnoldi_step(j)
        conv = (rhist[start:stop] < tol).cpu()  # one host sync per block
        if bool(conv.any()):
            it = start + int(torch.argmax(conv.to(torch.int8))) + 1
            done = True
        else:
            it = stop

    if it > 0:
        y = torch.linalg.solve_triangular(
            H[:it, :it], beta[:it, None], upper=True
        )[:, 0]
        dx = pc((Q[:it].T @ y).reshape(shape))
        resnorm = rhist[it - 1]
    else:
        dx = torch.zeros_like(b)
        resnorm = beta0
    return KrylovInfo(
        x=x0 + dx, iters=it, resnorm=resnorm, resnorm0=beta0, converged=done, rhist=rhist[:it]
    )


def _norm(v: torch.Tensor, allreduce=None) -> torch.Tensor:
    """The 2-norm of a flat vector, over every rank with `allreduce`."""
    if allreduce is None:
        return torch.linalg.vector_norm(v)
    return torch.sqrt(allreduce(torch.dot(v, v)))


def _gmres_restarted(matvec, b, x0, *, maxit, atol, rtol, pc, m, allreduce=None) -> KrylovInfo:
    """GMRES(m): restart cycles of m-dimensional solves. Convergence uses
    the first cycle's residual norm for the relative test."""
    if pc is None:
        pc = lambda v: v
    if x0 is None:
        x0 = torch.zeros_like(b)
    beta0 = _norm((b - matvec(x0)).reshape(-1), allreduce)
    tol = torch.maximum(
        torch.as_tensor(atol, dtype=b.dtype, device=b.device), (beta0 + 1e-16) * rtol
    )
    num_outer = -(-maxit // m)
    x, outer, total, hist = x0, 0, 0, []
    rnrm = beta0
    done = bool(beta0 < tol)
    while outer < num_outer and not done:
        # inner cycle stops early only on the global absolute tolerance
        sol = gmres(matvec, b, x, maxit=m, atol=tol, rtol=0.0, pc=pc, allreduce=allreduce)
        x = sol.x
        rnrm = _norm((b - matvec(x)).reshape(-1), allreduce)
        outer += 1
        total += sol.iters
        hist.append(sol.rhist)
        done = bool(rnrm < tol)
    rhist = torch.cat(hist) if hist else beta0.new_zeros(0)
    return KrylovInfo(x=x, iters=total, resnorm=rnrm, resnorm0=beta0, converged=done,
                      rhist=rhist)


def cg(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    maxit: int = 1000,
    atol: float = 1e-12,
    rtol: float = 1e-8,
    pc: Callable | None = None,
) -> KrylovInfo:
    """Preconditioned conjugate gradients for SPD operators (the reference
    declares CG but never implements it, krylov.c:42-51). Stops once
    ||r|| < max(atol, rtol * ||r0||) or after `maxit` iterations."""
    if pc is None:
        pc = lambda v: v
    if x0 is None:
        x0 = torch.zeros_like(b)
    dot = lambda u, v: torch.dot(u.reshape(-1), v.reshape(-1))
    x = x0
    r = b - matvec(x0)
    z = pc(r)
    p = z
    rz = dot(r, z)
    rnrm0 = torch.linalg.vector_norm(r.reshape(-1))
    tol = torch.clamp(rnrm0 * rtol, min=atol)
    rnrm = rnrm0
    iters = torch.zeros((), dtype=torch.int64, device=b.device)
    done = 0
    while done < maxit and bool(rnrm >= tol):  # one host sync per block
        block = min(_CG_BLOCK, maxit - done)
        for _ in range(block):
            active = rnrm >= tol
            ap = matvec(p)
            alpha = rz / dot(p, ap)
            x_new = x + alpha * p
            r_new = r - alpha * ap
            z = pc(r_new)
            rz_new = dot(r_new, z)
            p_new = z + (rz_new / rz) * p
            x = torch.where(active, x_new, x)
            r = torch.where(active, r_new, r)
            p = torch.where(active, p_new, p)
            rz = torch.where(active, rz_new, rz)
            rnrm = torch.where(active, torch.linalg.vector_norm(r_new.reshape(-1)), rnrm)
            iters = iters + active
        done += block
    return KrylovInfo(
        x=x, iters=int(iters), resnorm=rnrm, resnorm0=rnrm0, converged=bool(rnrm < tol)
    )
