"""Multi-node bootstrap and the node partition (port of
``cosmos_curate_tpu/parallel/distributed.py``).

Environment contract (set by the operator, a scheduler script or a chart):

  CURATE_COORDINATOR_ADDRESS  host:port of node rank 0
  CURATE_NUM_NODES            total hosts
  CURATE_NODE_RANK            this host's rank (else ``SLURM_NODEID``)

Where the reference calls ``jax.distributed.initialize``, the port joins a
``torch.distributed`` process group over **gloo** from the same three
variables. Gloo, not NCCL: nothing in the port runs a device collective
yet (tensor parallelism is ROADMAP queue A item 7), and NCCL refuses a
communicator whose ranks share one GPU, which two node processes on one
card do. Without a coordinator address (the partition mode) no group is
joined, as in the reference: each node takes every N-th task on its own.

Not ported: ``global_mesh_spec``, which needs the mesh module (item 7).
"""

from __future__ import annotations

import os

from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

COORDINATOR_ENV = "CURATE_COORDINATOR_ADDRESS"
NUM_NODES_ENV = "CURATE_NUM_NODES"
NODE_RANK_ENV = "CURATE_NODE_RANK"

_initialized = False


def maybe_initialize_distributed() -> bool:
    """Join the multi-host group when the env contract is present.

    Idempotent; True when running multi-host with a coordinator. A
    single-host run (no env) is untouched, so the same pipeline code runs
    in both modes."""
    global _initialized
    if _initialized:
        return True
    addr = os.environ.get(COORDINATOR_ENV)
    rank, num = node_rank_and_count()
    if not addr or num <= 1:
        return False
    import torch.distributed as dist

    logger.info("joining distributed world: %s rank %d/%d (gloo)", addr, rank, num)
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"tcp://{addr}", world_size=num, rank=rank)
    _initialized = True
    return True


def node_rank_and_count() -> tuple[int, int]:
    rank = int(os.environ.get(NODE_RANK_ENV, os.environ.get("SLURM_NODEID", "0")))
    num = int(os.environ.get(NUM_NODES_ENV, "1"))
    return rank, max(1, num)


def partition_tasks_for_node(tasks: list) -> list:
    """Deterministic task partition across nodes (host-level data
    parallelism): node i takes every num_nodes-th task. A single-node run
    gets the list unchanged.

    The partition comes after resume filtering, so nodes that run at
    different times (not one simultaneous step) can leave an item between
    partitions for one run; the next run picks it up. Simultaneous nodes
    see the same discovery list and split it exactly."""
    rank, num = node_rank_and_count()
    if num <= 1:
        return tasks
    return tasks[rank::num]
