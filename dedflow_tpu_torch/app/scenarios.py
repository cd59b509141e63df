"""The reference scenario (NumPy copy of the reference-scenario part of
dedflow_tpu/app/scenarios.py).

Initial condition MyFieldInit (main.c:286-321): u=(1,0,0), p=0, phi=x,
T=-x; BC layout of main.c:454-477 on a generated box mesh:

  reference bound 0 (strong u all comps) -> x- (inflow)
  reference bound 1 (no BCs: do-nothing) -> x+ (outflow)
  reference bound 2 (strong u_y)         -> y-/y+ (slip)
  reference bound 3 (strong u_z)         -> z-    (slip)
  reference bound 4 (weak/Nitsche)       -> z+
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dedflow_tpu_torch.config import BCSpec, SolverConfig
from dedflow_tpu_torch.mesh.mesh import Mesh


def reference_initial_state(mesh: Mesh) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(wgold, dwgold, dwg) per MyFieldInit + main.c:504-519."""
    n = mesh.num_node
    wg = np.zeros((n, 6))
    wg[:, 0] = 1.0  # u = (1, 0, 0)
    wg[:, 4] = mesh.xg[:, 0]  # phi = x
    wg[:, 5] = -mesh.xg[:, 0]  # T = -x
    return wg, np.zeros((n, 6)), np.zeros((n, 6))


def box_channel_bcs() -> tuple[BCSpec, ...]:
    """Reference BC roles on box side order [x-, x+, y-, y+, z-, z+]; x+
    carries no condition (do-nothing outflow), which pins the pressure."""
    return (
        BCSpec(boundary=0, strong_components=(0, 1, 2)),  # inflow (ref bound 0)
        BCSpec(boundary=2, strong_components=(1,)),  # y- slip (ref bound 2)
        BCSpec(boundary=3, strong_components=(1,)),  # y+ slip
        BCSpec(boundary=4, strong_components=(2,)),  # z- slip (ref bound 3)
        BCSpec(boundary=5, strong_components=(), weak=True),  # z+ weak (ref 4)
    )


def reference_scenario_config(**overrides) -> SolverConfig:
    cfg = SolverConfig(bcs=box_channel_bcs())
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
