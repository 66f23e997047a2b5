"""Serve a saved KernelMachine, one request at a time, on the GPU.

Loads a checkpoint written by either package's ``KernelMachine.save``,
resolves the decide arm that serves it (a ``stream`` machine serves through
``local``; ``--plan`` picks any arm), runs every batch bucket once, then
answers ``--requests`` requests of 1 to ``--max-batch`` rows drawn from
``--seed`` through the bucketed decider, and prints latency percentiles
and rows/s.

  PYTHONPATH=src python -m repro_torch.launch.kernel_serve \
      --ckpt machine.npz --serial --plan otf_shard

The concurrent continuous-batching engine (the reference's default mode,
and its ``--selftest``) comes with the serving slice, so ``--serial`` is
required for now.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np

from repro_torch.api import KernelMachine, available_plans
from repro_torch.api.infer import BucketedDecider
from repro_torch.serve import model_dim, percentiles, serving_plan


class ServingEndpoint(BucketedDecider):
    """Single-caller synchronous endpoint over one machine's decide arm."""

    def __init__(self, km: KernelMachine, max_batch: int = 256,
                 plan: Optional[str] = None):
        self.km = km
        self.plan = serving_plan(km, plan)
        super().__init__(km.decider(plan=self.plan), max_batch=max_batch)


def serve_stream(km: KernelMachine, *, requests: int, max_batch: int,
                 seed: int = 0, d: Optional[int] = None,
                 plan: Optional[str] = None):
    """Request-at-a-time loop; returns (endpoint, stats). A request's
    latency runs from its host rows to its host margins (the copy to the
    device, the decide arm, the copy back)."""
    if d is None:
        d = model_dim(km)
    endpoint = ServingEndpoint(km, max_batch=max_batch, plan=plan)
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, max_batch + 1, size=requests)
    endpoint.warmup(d)
    lat = []
    for s in sizes:
        Xq = rng.standard_normal((int(s), d)).astype(np.float32)
        t0 = time.perf_counter()
        endpoint(Xq)                       # host margins: synchronous
        lat.append(time.perf_counter() - t0)
    stats = {
        "requests": requests,
        "rows": int(sizes.sum()),
        "plan": endpoint.plan,
        "buckets": endpoint.n_buckets,
        **percentiles(lat),
        "rows_per_s": float(sizes.sum() / max(sum(lat), 1e-9)),
    }
    return endpoint, stats


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="checkpoint path")
    ap.add_argument("--serial", action="store_true", required=True,
                    help="single-client request-at-a-time loop (the only "
                         "mode so far)")
    ap.add_argument("--plan", default=None, choices=available_plans(),
                    help="decide arm override (default: the machine's own "
                         "plan; stream machines serve via 'local')")
    ap.add_argument("--max-batch", type=int, default=256,
                    help="rows per dispatch: the top batch bucket")
    ap.add_argument("--requests", type=int, default=64,
                    help="requests to answer")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the request sizes and rows")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default: cuda)")
    args = ap.parse_args(argv)

    km = KernelMachine.load(args.ckpt, device=args.device)
    print(f"[load ] solver={km.config.solver} loss={km.config.loss} "
          f"device={km.device} "
          f"state={ {k: tuple(v.shape) for k, v in km.state_.items()} }")
    _, stats = serve_stream(km, requests=args.requests,
                            max_batch=args.max_batch, seed=args.seed,
                            plan=args.plan)
    print(f"[serve] {stats}")
    return stats


if __name__ == "__main__":
    main()
