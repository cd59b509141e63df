"""Quadrature rules and linear-tet shape function tables (NumPy copy of
dedflow_tpu/fem/quadrature.py).

Reproduces the reference's tables exactly so converged results match:
- 4-point tet rule: weights gw = 1/24 (assemble.cu:43), shape values shlu
  at barycentric points (a,b,b,b) with a=0.5854101966249685,
  b=0.1381966011250105 (assemble.cu:44-47).
- Reference shape gradients: dN/dxi constant for linear tets
  (shlgradu, assemble.cu:49-52).
- 3-point facet (triangle) rule: weights 1/6 (assemble.cu:66), facet shape
  table shlub[face][q][a] (assemble.cu:68-83), zero on the opposite node.
- Reference facet normals for Nanson's formula (c_nv2, assemble.cu:114-118):
  deliberately NON-unit; their magnitude folds the ref-facet area ratio so
  that sum_q gwb * |n_phys| equals the physical facet area.
"""

from __future__ import annotations

import numpy as np

NSHL = 4  # shape functions per tet
NQR = 4  # volume quadrature points
NQRB = 3  # facet quadrature points
BS = 6  # DOF per node: u0,u1,u2,p,phi,T (main.c:29)

_A = 0.5854101966249685
_B = 0.1381966011250105

# GW[q]; SHL[q, a] = N_a(xi_q). The reference stores shlu[a*NQR+q]
# (column-major (NQR, NSHL)); this is its transpose in C order.
GW = np.full(NQR, 0.0416666666666667)
SHL = np.array(
    [
        [_A, _B, _B, _B],
        [_B, _A, _B, _B],
        [_B, _B, _A, _B],
        [_B, _B, _B, _A],
    ]
).T.copy()  # SHL[q, a]: row q lists N_a at point q

# dN_a/dxi_i, constant (assemble.cu:49-52): SHLGRAD[a, i]
SHLGRAD = np.array(
    [
        [-1.0, -1.0, -1.0],
        [1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0],
        [0.0, 0.0, 1.0],
    ]
)

GWB = np.full(NQRB, 0.1666666666666667)

_c = 0.1666666666666667
_d = 0.6666666666666667
# SHLB[face, q, a] = N_a at facet quadrature point q of local face `face`
# (face index == forn == opposite node). Matches c_shlub indexing
# c_shlub[NQRB*NSHL*iorn + iq*NSHL + aa] (assemble.cu:1105).
SHLB = np.array(
    [
        [[0.0, _c, _c, _d], [0.0, _c, _d, _c], [0.0, _d, _c, _c]],
        [[_c, 0.0, _c, _d], [_c, 0.0, _d, _c], [_d, 0.0, _c, _c]],
        [[_d, _c, 0.0, _c], [_c, _d, 0.0, _c], [_c, _c, 0.0, _d]],
        [[_c, _d, _c, 0.0], [_c, _c, _d, 0.0], [_d, _c, _c, 0.0]],
    ]
)

# Reference-space facet normals for Nanson's formula (c_nv2,
# assemble.cu:114-118); row index = forn. NOT unit vectors by design.
REF_FACE_NORMALS = np.array(
    [
        [1.0, 1.0, 1.0],
        [-1.0, 0.0, 0.0],
        [0.0, -1.0, 0.0],
        [0.0, 0.0, -1.0],
    ]
)
