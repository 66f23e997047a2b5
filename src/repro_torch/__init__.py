"""repro_torch — the kernel machine in PyTorch, for NVIDIA Hopper GPUs.

A port of :mod:`repro` (JAX, TPU) that mirrors its module tree: the
counterpart of ``repro/api/infer.py`` is ``repro_torch/api/infer.py``.
The JAX package stays the reference the port is tested against; this
package imports neither ``jax`` nor ``repro``.

Every Pallas kernel on a ported path is a CUDA C++ kernel written for
``sm_90a`` (``repro_torch/kernels/csrc``), compiled with ``nvcc`` on first
use and bound through ``ctypes``. On a CUDA tensor the kernel runs; on a
CPU tensor its plain PyTorch version runs. Entry points run on the GPU
unless the caller passes ``device="cpu"``.

Ported so far: serving (checkpoint load, the ``local`` and fused decide
arms, bucketed serving, ``launch.kernel_serve --serial``) and training on
one GPU (``KernelMachine.fit`` and ``partial_fit``: TRON over formulation
(4) under the ``local`` and ``otf_shard`` plans). See ROADMAP.md for what
comes next.
"""
