"""GNN inference serving engine, single lane (port of ``repro.serve``).

* request plane — ``batcher.DynamicBatcher`` (deadline/size triggers,
  skip-ahead FIFO packing);
* data plane    — per-request counter-hash forest sampling on host worker
  threads, or on the device inside the step (``device_sampler``), stacked
  into power-of-two shape buckets;
* compute plane — one step per (arch, bucket, backend) through the backend
  registry, LRU-cached with an explicit rebuild counter;
* control plane — typed failures (``errors``), deterministic fault
  injection (``chaos``) with the engine's retry path, and
  ``telemetry.TelemetryHub`` (counters, events, a sampled time-series and
  the JSONL flight recorder);
* observability — per-request span trees (``tracing``) and the metrics
  plane (``metrics.MetricsRegistry``, served over HTTP by
  ``launch.metrics_server``).

Correctness anchor: batched serving equals offline one-request-at-a-time
inference on the same sampled trees to ≤1e-5; every accepted request
settles exactly once (result XOR typed error).
"""
from repro_torch.serve.batcher import DynamicBatcher, ServeRequest
from repro_torch.serve.buckets import (BucketStructure, bucket_for,
                                       build_bucket_structure, stack_trees)
from repro_torch.serve.chaos import (ChaosInjector, InjectedSamplerFault,
                                     LaneFault)
from repro_torch.serve.compute import (FeatureStore, StepCache,
                                       build_infer_step)
from repro_torch.serve.device_sampler import (DeviceSamplerPlane,
                                              pack_trees,
                                              sample_forest_device,
                                              tree_key_mix)
from repro_torch.serve.engine import (GNNServer, SamplerPool,
                                      offline_inference, offline_replay)
from repro_torch.serve.errors import (DeadlineExceeded, DrainTimeout,
                                      LaneFailure, Overloaded,
                                      RetriesExhausted, SamplerError,
                                      ServeError, ServerClosed,
                                      TransientStepError)
from repro_torch.serve.metrics import (LatencyHistogram, MetricsRegistry,
                                       parse_exposition)
from repro_torch.serve.scheduler import LaneSlotPools, SlotPool, pack_fifo
from repro_torch.serve.telemetry import TelemetryHub, percentiles_ms
from repro_torch.serve.tracing import (SCHEMA_VERSION, TERMINAL_SPANS,
                                       Tracer, verify_trace, verify_traces)

__all__ = [
    "DynamicBatcher", "ServeRequest",
    "BucketStructure", "bucket_for", "build_bucket_structure", "stack_trees",
    "ChaosInjector", "InjectedSamplerFault", "LaneFault",
    "FeatureStore", "StepCache", "build_infer_step",
    "DeviceSamplerPlane", "pack_trees", "sample_forest_device",
    "tree_key_mix",
    "GNNServer", "SamplerPool", "offline_inference", "offline_replay",
    "ServeError", "SamplerError", "DeadlineExceeded", "DrainTimeout",
    "TransientStepError", "RetriesExhausted", "Overloaded", "LaneFailure",
    "ServerClosed",
    "LatencyHistogram", "MetricsRegistry", "parse_exposition",
    "LaneSlotPools", "SlotPool", "pack_fifo",
    "TelemetryHub", "percentiles_ms",
    "SCHEMA_VERSION", "TERMINAL_SPANS", "Tracer",
    "verify_trace", "verify_traces",
]
