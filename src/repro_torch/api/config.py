"""Frozen, JSON-round-trippable configuration for :class:`KernelMachine`.

The same fields, in the same order, with the same ``to_dict`` keys as the
reference (``repro.api.config``), so a checkpoint written by either
package loads in the other. Fields for parts the port does not have yet
(the stream plan, the other solvers, the multi-device axes) are carried
unchanged.
Two fields are carried for checkpoint compatibility only and select
nothing in the port: ``backend`` ("jnp" | "pallas"), since a CUDA tensor
always runs the hand-written kernels and a CPU tensor their plain versions;
and ``otf_block_rows``, since the plain versions chunk rows by m alone
(``repro_torch.kernels.kmvp.otf_block_rows``), whatever the batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.losses import Loss, get_loss
from repro_torch.core.nystrom import KernelSpec
from repro_torch.core.tron import TronConfig
from repro_torch.kernels.policy import DtypePolicy, get_policy


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Knobs of the out-of-core ``stream`` plan (carried for round-trips;
    the plan's chunk pipeline comes with the stream slice)."""

    chunk_rows: Optional[int] = None
    mmap: bool = True
    cache_chunks: Optional[int] = None
    prefetch: int = 2


@dataclasses.dataclass(frozen=True)
class MachineConfig:
    """Everything needed to train and serve one kernel machine."""

    kernel: KernelSpec = KernelSpec()
    loss: str = "squared_hinge"        # by name -> core.losses.get_loss
    lam: float = 1.0
    solver: str = "tron"               # tron | linearized | rff | ppacksvm
    plan: str = "local"                # local | shard_map | auto | otf
                                       #   | otf_shard | stream
    tron: TronConfig = TronConfig()
    backend: str = "jnp"               # carried for checkpoints; selects
                                       # nothing in the port
    seed: int = 0
    dtype_policy: str = "fp32"         # fp32 | bf16 | fp16 (fp32 served)

    # basis selection when fit() is called without an explicit basis
    m: int = 256
    basis_strategy: str = "random"     # random | kmeans | auto

    # solver-specific knobs
    rff_features: int = 256
    ppack_epochs: int = 1
    ppack_size: int = 64
    linearized_rank: Optional[int] = None

    # execution-plan knobs
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: Optional[str] = None
    otf_block_rows: Optional[int] = None  # carried for checkpoints only;
                                          # selects nothing in the port
    stream: StreamConfig = StreamConfig()

    def __post_init__(self):
        get_loss(self.loss)            # fail fast on unknown loss names
        get_policy(self.dtype_policy)  # fail fast on unknown policy names

    def get_loss(self) -> Loss:
        return get_loss(self.loss)

    def get_policy(self) -> DtypePolicy:
        return get_policy(self.dtype_policy)

    def replace(self, **kw) -> "MachineConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------- round-trip
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["data_axes"] = list(self.data_axes)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MachineConfig":
        d = dict(d)
        d["kernel"] = KernelSpec(**d["kernel"])
        d["tron"] = TronConfig(**d["tron"])
        d["data_axes"] = tuple(d["data_axes"])
        # checkpoints written before the stream plan carry no "stream" key
        d["stream"] = StreamConfig(**d.get("stream", {}))
        return cls(**d)
