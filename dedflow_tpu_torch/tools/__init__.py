"""The port's probes of single kernel primitives (counterparts of the JAX
package's tools/gmicro.py and tools/gather_probe.py), run as

    python -m dedflow_tpu_torch.tools.gmicro [n]
    python -m dedflow_tpu_torch.tools.gather_probe [W]

and the timing and roofline arithmetic they share with chip_smoke.py
(`timing.py`)."""
