"""Core math of formulation (4): kernels, losses and the TRON settings."""
from repro_torch.core.losses import LOSSES, Loss, get_loss, register_loss
from repro_torch.core.nystrom import (KernelSpec, build_C, build_W, gram,
                                      predict, sqdist)
from repro_torch.core.tron import TronConfig

__all__ = ["KernelSpec", "Loss", "LOSSES", "TronConfig", "build_C",
           "build_W", "get_loss", "gram", "predict", "register_loss",
           "sqdist"]
