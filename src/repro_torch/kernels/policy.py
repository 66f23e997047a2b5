"""Dtype policy for the kernel compute path.

The same names, fields and JSON strings as the reference
(``repro.kernels.policy``) so ``MachineConfig.dtype_policy`` and
checkpoints cross-load:

    compute — dtype operands are cast to before the tile products.
    accum   — dtype of every accumulation. fp32 always.
    param   — dtype of the optimizer state. fp32.
    store   — dtype checkpointed arrays are written in (``"int8"`` selects
              quantized checkpoints).

Fields are dtype *names* (strings), which keeps the dataclass hashable;
torch dtypes are resolved on demand. The port serves the fp32 policy only
for now: a bf16/fp16 policy reaching the kernels raises
``NotImplementedError`` (see :func:`repro_torch.kernels.ops.require_fp32`).
"""
from __future__ import annotations

import dataclasses

import torch

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def _torch_dtype(name: str) -> torch.dtype:
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise TypeError(f"unknown dtype name {name!r}; known: "
                        f"{sorted(_TORCH_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """What the kernel layer computes, accumulates, optimizes, and stores in."""

    compute: str = "float32"
    accum: str = "float32"
    param: str = "float32"
    store: str = "float32"

    def __post_init__(self):
        for field in ("compute", "accum", "param"):
            _torch_dtype(getattr(self, field))    # fail fast on typos
        if self.store != "int8":
            _torch_dtype(self.store)

    @property
    def compute_dtype(self) -> torch.dtype:
        return _torch_dtype(self.compute)

    @property
    def accum_dtype(self) -> torch.dtype:
        return _torch_dtype(self.accum)

    @property
    def param_dtype(self) -> torch.dtype:
        return _torch_dtype(self.param)

    @property
    def is_default(self) -> bool:
        """True when every dtype is fp32."""
        return (self.compute == self.accum == self.param == "float32"
                and self.store == "float32")


FP32 = DtypePolicy()
BF16 = DtypePolicy(compute="bfloat16")
FP16 = DtypePolicy(compute="float16")

#: Named policies — the values ``MachineConfig.dtype_policy`` accepts.
POLICIES = {"fp32": FP32, "bf16": BF16, "fp16": FP16}


def get_policy(policy) -> DtypePolicy:
    """Resolve a policy name / DtypePolicy / None (-> fp32 default)."""
    if policy is None:
        return FP32
    if isinstance(policy, DtypePolicy):
        return policy
    if isinstance(policy, str):
        try:
            return POLICIES[policy]
        except KeyError:
            raise ValueError(
                f"unknown dtype policy {policy!r}; registered: "
                f"{sorted(POLICIES)}") from None
    raise TypeError(f"dtype policy must be a name, DtypePolicy, or None; "
                    f"got {type(policy).__name__}")
