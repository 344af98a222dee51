"""GNN inference serving engine, single lane (port of ``repro.serve``).

* request plane — ``batcher.DynamicBatcher`` (deadline/size triggers,
  skip-ahead FIFO packing);
* data plane    — per-request counter-hash forest sampling on host worker
  threads, or on the device inside the step (``device_sampler``), stacked
  into power-of-two shape buckets;
* compute plane — one step per (arch, bucket, backend) through the backend
  registry, LRU-cached with an explicit rebuild counter.

Correctness anchor: batched serving equals offline one-request-at-a-time
inference on the same sampled trees to ≤1e-5; every accepted request
settles exactly once (result XOR typed error).
"""
from repro_torch.serve.batcher import DynamicBatcher, ServeRequest
from repro_torch.serve.buckets import (BucketStructure, bucket_for,
                                       build_bucket_structure, stack_trees)
from repro_torch.serve.compute import (FeatureStore, StepCache,
                                       build_infer_step)
from repro_torch.serve.device_sampler import (DeviceSamplerPlane,
                                              pack_trees,
                                              sample_forest_device,
                                              tree_key_mix)
from repro_torch.serve.engine import (GNNServer, SamplerPool,
                                      offline_inference, offline_replay)
from repro_torch.serve.errors import (DeadlineExceeded, DrainTimeout,
                                      SamplerError, ServeError, ServerClosed)

__all__ = [
    "DynamicBatcher", "ServeRequest",
    "BucketStructure", "bucket_for", "build_bucket_structure", "stack_trees",
    "FeatureStore", "StepCache", "build_infer_step",
    "DeviceSamplerPlane", "pack_trees", "sample_forest_device",
    "tree_key_mix",
    "GNNServer", "SamplerPool", "offline_inference", "offline_replay",
    "ServeError", "SamplerError", "DeadlineExceeded", "DrainTimeout",
    "ServerClosed",
]
