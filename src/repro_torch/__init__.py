"""DRIFT on PyTorch and CUDA: the port of ``repro`` to an NVIDIA Hopper card.

Module names mirror the JAX package (``repro_torch.core.exec_ctx`` is the
counterpart of ``repro.core.exec_ctx``, and so on). This package imports
``torch`` and never ``jax``, and nothing of ``repro``: where it needs a
pure-Python piece of the reference (the DVFS fit, the rollback cadence) it
keeps its own copy.

Every protected GEMM runs through the hand-written int8 ABFT kernel
(``kernels/csrc/abft_matmul.cu``) and the rollback kernel
(``kernels/csrc/rollback_correct.cu``); every self-attention through the
attention kernel (``kernels/csrc/flash_attention.cu``). Each kernel module
keeps a plain PyTorch version of its function, which its wrapper takes for
tensors on the CPU only: a CUDA tensor launches the kernel or raises.

Entry points (``serving.DriftServeEngine``, ``launch.serve``) run on the
card unless the caller passes ``device="cpu"``; with no GPU present they
raise instead of falling back.
"""
