"""rrt_tpu_torch — the PyTorch and CUDA port of rrt_tpu.

The same relativistic path tracer on an NVIDIA GPU: every module mirrors
its counterpart's path under `rrt_tpu/`, plain tensor code is PyTorch,
and each Pallas TPU kernel of the JAX package is a CUDA kernel written for
Hopper (`ops/csrc/`: the traversal, the bench's toolchain probe and the
cost micro-probes). The package
imports `torch` and never `jax`; the numpy-only host modules of `rrt_tpu`
(COLLADA, PNG, mesh, clusters, config, film, stats) are reused as they are.
"""
