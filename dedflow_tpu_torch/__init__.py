"""PyTorch + CUDA port of dedflow_tpu: the VMS Navier-Stokes + level-set +
temperature solver on the structured-lattice tier of a generated box mesh.

The JAX package `dedflow_tpu` is the reference; this package imports torch
and never jax. On CUDA the lattice residual, the lattice Jacobian and the
DIA SpMV run as hand-written kernels (csrc/), built with nvcc at first use;
on the CPU the same functions run as plain torch code.
"""
