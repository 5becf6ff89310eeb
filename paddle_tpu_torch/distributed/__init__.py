"""Distributed pieces of the port (counterpart of `paddle_tpu/distributed/`):
process bring-up over a TCPStore (`parallel.py`), the eager collectives
over the store's key-value client with the quantized all-reduce
(`collective.py`), sharded checkpoints (`checkpoint.py`), the training
fleet's liveness heartbeats (`liveness.py`) and the fleet's node
registries and heartbeat watchers (`fleet/elastic.py`). The mesh,
ZeRO-1, ring and Ulysses attention, `launch`, `rpc`, `auto_parallel` and
`fleet/meta_parallel` are ROADMAP A6."""
from paddle_tpu_torch.distributed.parallel import (  # noqa: F401
    init_parallel_env, get_rank, get_world_size, is_initialized, barrier,
    ParallelEnv,
)
from paddle_tpu_torch.distributed.collective import (  # noqa: F401
    all_reduce, all_gather, all_gather_object, reduce, broadcast, scatter,
    reduce_scatter, alltoall, alltoall_single, send, recv, isend, irecv,
    new_group, get_group, wait, ReduceOp, Group, split_group,
    destroy_process_group,
)
from paddle_tpu_torch.distributed.checkpoint import (  # noqa: F401
    save_sharded, load_sharded, async_save)
from paddle_tpu_torch.distributed import fleet  # noqa: F401
