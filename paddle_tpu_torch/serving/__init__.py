"""Multi-replica serving of the port, the tier above one engine process
(counterpart of `paddle_tpu/serving/`):

- `disagg.py`: the prefix page-chain hash every prefix store keys on, the
  ``PTKS1`` page stream of disaggregated prefill and its assembler, and
  the router's fleet `PrefixDirectory`.
- `router.py`: `Router`, a front door over N replicas that speaks the
  serve wire protocol: membership from the node registry or a static
  list, placement policies (`POLICIES`), a circuit breaker a replica,
  bounded resubmission, the two-phase prefill/decode relay with prefix
  affinity, and the cancel broadcast. ``python -m
  paddle_tpu_torch.serving.router`` runs it.
- `autoscale.py`: `Autoscaler`, which grows and shrinks the fleet behind
  one or more routers through a pluggable launcher (`CallbackLauncher`),
  draining a replica by live migration.

Run a fleet:

    python -m paddle_tpu_torch.inference.serve --gpt-config g.json \
        --registry-dir /mnt/registry --replica-id r0      # each replica
    python -m paddle_tpu_torch.serving.router --registry-dir /mnt/registry
"""
from paddle_tpu_torch.serving.autoscale import (Autoscaler, AutoscalePolicy,
                                                CallbackLauncher)
from paddle_tpu_torch.serving.disagg import (KVStreamAssembler,
                                             PrefixDirectory,
                                             prompt_page_hashes,
                                             stream_records)
from paddle_tpu_torch.serving.router import POLICIES, ReplicaState, Router

__all__ = ["Router", "ReplicaState", "POLICIES", "Autoscaler",
           "AutoscalePolicy", "CallbackLauncher", "KVStreamAssembler",
           "PrefixDirectory", "prompt_page_hashes", "stream_records"]
