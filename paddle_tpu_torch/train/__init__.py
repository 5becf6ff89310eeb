"""Training of the port (counterpart of `paddle_tpu/train/`).

scan_step.py — the GPT train step: stacked [nl, ...] params, microbatched
forward/backward over the port's kernels, the f32 AdamW update, the
in-step bad-step skip, and the split grads/reduce/apply mode a fleet's
reducer drives.

fault_tolerance.py — preemption-safe checkpointing around the step:
durable checksummed checkpoints with a crash-consistent LATEST pointer,
SIGTERM -> drain -> checkpoint -> exit, bit-identical resume, and the
consecutive-bad-step rollback ladder; on a fleet, per-rank key-partitioned
shard writes published behind a KV barrier.

elastic.py — elastic multi-process training: the FleetReducer (grad
averaging + the SIGTERM stop vote), per-step liveness heartbeats turning
a dead peer into typed PeerLost, and the ElasticController that
relaunches the fleet at the surviving world size from the last
fleet-complete checkpoint.
"""
from paddle_tpu_torch.train.scan_step import (H100_BF16_PEAK, ScanTrainStep,
                                              ScanUnsupported)
from paddle_tpu_torch.train.fault_tolerance import (CheckpointCorrupt,
                                                    CheckpointIncomplete,
                                                    CheckpointManager,
                                                    TooManyBadSteps)
from paddle_tpu_torch.train.elastic import (EXIT_PEER_LOST,
                                            ElasticController, FleetReducer,
                                            PeerLost, elastic_worker_main,
                                            run_elastic_worker)

__all__ = ["H100_BF16_PEAK", "ScanTrainStep", "ScanUnsupported",
           "CheckpointManager",
           "TooManyBadSteps", "CheckpointCorrupt", "CheckpointIncomplete",
           "PeerLost", "FleetReducer", "ElasticController",
           "run_elastic_worker", "elastic_worker_main", "EXIT_PEER_LOST"]
