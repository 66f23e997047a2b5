"""The gram kernel: C = k(X, Z), materialized (``csrc/gram.cu``).

Replaces ``repro/kernels/gram.py::gram_pallas`` (the TPU kernel behind
``repro.kernels.ops.gram``). On an H100 it is bound by operations, not
bytes: each output costs 2 d fp32 flops on the CUDA cores and is written
once. See the note at the top of ``csrc/gram.cu`` for the design.

:func:`gram` is the wrapper: a CUDA tensor launches the kernel, a CPU
tensor takes :func:`gram_plain`, the kernel's plain PyTorch version (which
the CPU tests use and ``chip_smoke.py`` holds the kernel against). Nothing
falls back: a tensor the kernel does not take raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: Kernel launches so far (the CPU path never counts). ``chip_smoke.py``
#: zeroes it before driving the serving path and reads it after.
launches = 0

KINDS = {"gaussian": 0, "linear": 1}


def gram_plain(x, z, *, kind: str = "gaussian", sigma: float = 1.0):
    """The kernel's arithmetic in plain PyTorch: fp32 cross term, squared
    norms, d2 = max(|x|^2 + |z|^2 - 2 x.z, 0), exp(-d2 / 2 sigma^2)."""
    xz = x @ z.T
    if kind == "linear":
        return xz
    xx = torch.sum(x * x, dim=1, keepdim=True)
    zz = torch.sum(z * z, dim=1, keepdim=True).T
    d2 = torch.clamp_min(xx + zz - 2.0 * xz, 0.0)
    return torch.exp(-d2 / (2.0 * sigma ** 2))


def check_operands(fn: str, kind: str, **tensors) -> torch.device:
    """Raise unless every tensor is a contiguous 2-D fp32 tensor on one CPU
    or CUDA device and ``kind`` is known; return that device."""
    if kind not in KINDS:
        raise ValueError(f"{fn}: unknown kernel kind {kind!r}; "
                         f"known: {sorted(KINDS)}")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{fn}: operands on different devices: "
                         f"{ {k: str(t.device) for k, t in tensors.items()} }")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: no kernel for device {device}")
    for name, t in tensors.items():
        if t.dim() != 2:
            raise ValueError(f"{fn}: {name} must be 2-D, got shape "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"{fn}: {name} is {t.dtype}; the kernels take float32 only "
                f"(bf16/fp16 come with the precision slice)")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    return device


def launch_args(*tensors):
    """Pointers of ``tensors`` and their device's current stream (the
    kernels launch on PyTorch's stream and never synchronize). Call it, and
    launch, inside ``torch.cuda.device(...)`` of that device: the C side
    launches on the thread's current device, and the guard restores the
    caller's device afterwards."""
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    return [t.data_ptr() for t in tensors], stream


def gram(x, z, *, kind: str = "gaussian", sigma: float = 1.0):
    """C = k(x, z) for x (n, d) and z (m, d), fp32, as an (n, m) tensor."""
    global launches
    device = check_operands("gram", kind, x=x, z=z)
    if x.shape[1] != z.shape[1]:
        raise ValueError(f"gram: feature dims differ: x {tuple(x.shape)}, "
                         f"z {tuple(z.shape)}")
    if device.type == "cpu":
        return gram_plain(x, z, kind=kind, sigma=sigma)
    n, d = x.shape
    m = z.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=device)
    lib = _build.load("gram")
    with torch.cuda.device(device):
        (px, pz, po), stream = launch_args(x, z, out)
        err = lib.gram_launch(px, pz, po, n, m, d, KINDS[kind],
                              2.0 * sigma ** 2, stream)
    if err:
        raise RuntimeError(f"gram kernel launch failed: cudaError {err} "
                           f"(n={n}, m={m}, d={d})")
    launches += 1
    return out
