"""Core math of formulation (4): kernels, losses, the objective and TRON."""
from repro_torch.core.formulation import Formulation4
from repro_torch.core.losses import LOSSES, Loss, get_loss, register_loss
from repro_torch.core.nystrom import (KernelSpec, build_C, build_W, gram,
                                      predict, sqdist)
from repro_torch.core.tron import TronConfig, TronResult, tron

__all__ = ["Formulation4", "KernelSpec", "Loss", "LOSSES", "TronConfig",
           "TronResult", "build_C", "build_W", "get_loss", "gram",
           "predict", "register_loss", "sqdist", "tron"]
