from repro_torch.checkpoint.ckpt import (IOWarningSink, load_arrays,
                                         save_checkpoint)

__all__ = ["IOWarningSink", "load_arrays", "save_checkpoint"]
