"""PyTorch + CUDA port of the XAMBA Mamba-2 serving path.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``core``, ``configs``, ``nn``, ``kernels``, ``models``, ``serve``,
``launch``) and runs the wave engine's Mamba-2 path on an NVIDIA GPU.
The two Pallas kernels on that path (``mamba2_step`` and
``mamba2_prefill_pallas``) are replaced by CUDA kernels written for
Hopper (``csrc/``), built with ``nvcc`` at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on a CPU tensor every kernel wrapper's plain PyTorch version runs
instead.  Nothing here imports ``jax`` or the ``repro`` package.
"""
