"""Process bring-up (counterpart of `paddle_tpu/distributed/parallel.py`, the
reference's `python/paddle/distributed/parallel.py:100` init_parallel_env).

The JAX package joins the multi-controller JAX cluster, whose coordination
service plays the TCPStore role. The port joins a
`torch.distributed.TCPStore` that rank 0 hosts at ``PADDLE_MASTER`` (or the
first of ``PADDLE_TRAINER_ENDPOINTS``): the store is the fleet's key-value
board, read through `collective._kv_client()` with the coordination
client's methods. A world of 1 needs no store. Rank 0 hosts the store, so
rank 0's death takes it down, as the JAX service dies with its process.
"""
from __future__ import annotations

import datetime
import os

_initialized = False
_store = None                 # the fleet's TCPStore, once joined
_STORE_TIMEOUT_S = 300.0      # connect and store-wide wait bound


class ParallelEnv:
    """ref: `python/paddle/fluid/dygraph/parallel.py` ParallelEnv."""

    def __init__(self):
        self._rank = int(os.environ.get("PADDLE_TRAINER_ID",
                                        os.environ.get("RANK", "0")))
        self._world_size = int(os.environ.get(
            "PADDLE_TRAINERS_NUM", os.environ.get("WORLD_SIZE", "1")))
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._endpoints = eps.split(",") if eps else []
        self._current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def rank(self):
        return self._rank

    @property
    def local_rank(self):
        return self._rank

    @property
    def world_size(self):
        return self._world_size

    @property
    def nranks(self):
        return self._world_size

    @property
    def dev_id(self):
        return int(os.environ.get("FLAGS_selected_gpus", "0"))

    @property
    def trainer_endpoints(self):
        return self._endpoints

    @property
    def current_endpoint(self):
        return self._current_endpoint


def _join_store(env):
    """Connect to (rank 0: host) the fleet's TCPStore at the coordinator
    address the launch env names."""
    from torch.distributed import TCPStore
    coordinator = os.environ.get("PADDLE_MASTER") or (
        env.trainer_endpoints[0] if env.trainer_endpoints else None)
    if not coordinator:
        raise RuntimeError(
            f"init_parallel_env: world size {env.world_size} needs a "
            "coordinator address (PADDLE_MASTER or PADDLE_TRAINER_ENDPOINTS)")
    host, _, port = coordinator.rpartition(":")
    return TCPStore(host or "127.0.0.1", int(port), env.world_size,
                    is_master=env.rank == 0,
                    timeout=datetime.timedelta(seconds=_STORE_TIMEOUT_S),
                    wait_for_workers=False)


def init_parallel_env():
    """Join the fleet. Multi-process: the TCPStore at the launch env's
    coordinator (rank 0 hosts it). Single-process: no-op. With
    ``PADDLE_HEARTBEAT_FILE`` set, start the file heartbeat the launch
    controller watches (`fleet/elastic.py::start_heartbeat`)."""
    global _initialized, _store
    if _initialized:
        return ParallelEnv()
    env = ParallelEnv()
    if env.world_size > 1 and _store is None:
        _store = _join_store(env)
    hb = os.environ.get("PADDLE_HEARTBEAT_FILE")
    if hb:
        from paddle_tpu_torch.distributed.fleet.elastic import start_heartbeat
        start_heartbeat(hb)
    _initialized = True
    return env


def is_initialized():
    return _initialized or _store is not None


def get_rank(group=None):
    if group is not None:
        return group.get_group_rank(get_rank())
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def get_world_size(group=None):
    if group is not None:
        return group.world_size
    return int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))


def barrier(group=None):
    """Block until every process arrives. World 1: nothing to wait for.
    With a liveness monitor installed (elastic training) the polling
    `liveness.kv_barrier`, which turns a dead peer into typed PeerLost;
    else the store's one-shot ``wait_at_barrier``."""
    if get_world_size(group) == 1:
        return
    from paddle_tpu_torch.distributed import liveness
    from paddle_tpu_torch.distributed.collective import _kv_client
    _barrier_seq[0] += 1
    client = _kv_client()
    if liveness.current() is not None:
        liveness.kv_barrier(client, f"pbar/{_barrier_seq[0]}",
                            rank=get_rank(), world=get_world_size(),
                            timeout_ms=60_000)
        if get_rank() == 0 and _barrier_seq[0] >= 3:
            # two-generations-back sweep: seq N completing proves everyone
            # is past seq N-2's listing loop
            liveness.kv_barrier_cleanup(client,
                                        f"pbar/{_barrier_seq[0] - 2}")
        return
    client.wait_at_barrier(f"ptpu_barrier/{_barrier_seq[0]}", 60_000)


_barrier_seq = [0]
