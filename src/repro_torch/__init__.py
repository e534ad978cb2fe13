"""PyTorch port of the FAM DRAM-cache prefetching simulator.

Mirrors the module layout of the JAX package ``repro`` (each file names
its counterpart) and runs on an NVIDIA GPU: the per-event DRAM-cache step
is a hand-written CUDA kernel (:mod:`repro_torch.kernels.famsim_step`),
the rest of the step is plain PyTorch. Entry points take ``device`` and
default to ``"cuda"``; tests pass ``device="cpu"``.
"""
