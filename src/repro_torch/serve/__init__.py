"""repro_torch.serve — serving over the plan registry's decide arms.

So far the pieces the synchronous server needs: bucketing
(:class:`~repro_torch.api.infer.BucketedDecider`), a registry of served
machines, and the latency percentile helper. The concurrent engine comes
with the serving slice (ROADMAP.md).
"""
from repro_torch.api.infer import BucketedDecider, bucket_rows, scatter_rows
from repro_torch.serve.metrics import percentiles
from repro_torch.serve.registry import (ModelRegistry, ServedModel,
                                        model_dim, serving_plan)

__all__ = ["BucketedDecider", "ModelRegistry", "ServedModel", "bucket_rows",
           "model_dim", "percentiles", "scatter_rows", "serving_plan"]
