"""Execution plans, decide side: which arm serves each plan's margins.

* ``local``  — :func:`~repro_torch.api.infer.decide_local`, the dense arm
  on the gram kernel.
* ``shard_map`` / ``auto`` / ``otf`` / ``otf_shard`` —
  :func:`~repro_torch.api.infer.decide_fused`, the fused arm on the kmvp
  kernel.
* ``stream`` — served through the ``local`` arm, as the reference's
  serving registry does (``repro/serve/registry.py::serving_plan``); the
  chunked out-of-core arm comes with the stream slice.

The plans' training arms come with the training slice (ROADMAP.md).
"""
from __future__ import annotations

from repro_torch.api.infer import decide_fused, decide_local
from repro_torch.api.registry import register_plan

register_plan("local", decide=decide_local)
for _name in ("shard_map", "auto", "otf", "otf_shard"):
    register_plan(_name, decide=decide_fused)
register_plan("stream", decide=decide_local)
