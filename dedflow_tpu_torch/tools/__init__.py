"""The port's tools (counterparts of the JAX package's tools/): the probes
of single kernel primitives,

    python -m dedflow_tpu_torch.tools.gmicro [n]
    python -m dedflow_tpu_torch.tools.gather_probe [W]

and the timing and roofline arithmetic they share with chip_smoke.py
(`timing.py`); the correctness checks on the card,

    python -m dedflow_tpu_torch.tools.residual_check [n]
    python -m dedflow_tpu_torch.tools.selfcheck [n]
    python -m dedflow_tpu_torch.tools.nonlinear_f64_check [box_n] [steps]

each printing one JSON line; and the mesh converter into the solver's HDF5
schema (`mesh_convert.py`, which needs meshio)."""
