"""Hand-written CUDA kernels, their plain PyTorch versions, and the
dispatch layer (:mod:`repro_torch.kernels.ops`) the rest of the port calls."""
