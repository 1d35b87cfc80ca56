"""rrt_tpu_torch — the PyTorch and CUDA port of rrt_tpu.

The same relativistic path tracer on NVIDIA GPUs: every module mirrors
its counterpart's path under `rrt_tpu/`, plain tensor code is PyTorch,
and each Pallas TPU kernel of the JAX package is a CUDA kernel written for
Hopper (`ops/csrc/`: the traversal, the bench's toolchain probe and the
cost micro-probes). `parallel/` shards a batch's lanes over processes, one
per device, with `torch.distributed` (NCCL between cards, gloo on the
CPU). The package imports `torch` and never `jax`, nor anything of
`rrt_tpu`: it keeps its own copies of the JAX package's numpy host modules
(COLLADA, PNG, mesh, clusters, config, film, stats).
"""
