"""Multi-process launch wiring on torch.distributed.

Port of wave_tracer_tpu/parallel/launch.py. The JAX package runs one
controller per host over ONE global device mesh; here a process group
takes the mesh's place, with one rank per device: every rank runs the same
program, calls `initialize_distributed()` first, renders its share of the
lanes on its own device (`local_device`), and the partial films merge with
an all-reduce (parallel/dist.py). Rank 0 writes the outputs.

The backend is NCCL for CUDA devices and gloo for the CPU (gloo also
all-reduces CUDA tensors, through the host, and lets two ranks share one
card, which NCCL refuses). An explicit `backend`, or else the environment
variable WT_DIST_BACKEND (the CLI's way to ask, e.g. `WT_DIST_BACKEND=gloo`
for two ranks on one card), overrides the choice; nothing falls back by
itself.

Launch recipes::

    # torchrun sets RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT / LOCAL_RANK
    torchrun --nproc-per-node 4 -m wave_tracer_tpu_torch render scene.xml \\
        -o out --distributed

    # or by hand, the same command for each rank 0..N-1
    python -m wave_tracer_tpu_torch render scene.xml -o out --distributed \\
        --coordinator 10.0.0.1:29500 --num-processes 4 --process-id $RANK
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# how long a rank waits for its peers (at init and at each collective)
# before it raises instead of hanging
TIMEOUT_S = 300.0


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None,
                           device: str = "cuda",
                           timeout_s: float = TIMEOUT_S) -> bool:
    """Join the process group of a multi-process render.

    coordinator: `host:port` (tcp://) or a full init URL (`file://...`);
    without one the group comes from the environment (`env://`, torchrun's
    RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT), the counterpart of the
    JAX package's no-argument form. Returns False, starting nothing, when
    a single process has nothing to coordinate; when a coordinator or
    more than one process was asked for, a failure raises (a peer that
    never arrives raises after `timeout_s`). `device` ("cuda" or "cpu")
    picks the backend, NCCL or gloo, unless `backend` or WT_DIST_BACKEND
    names one."""
    if num_processes is not None and num_processes <= 1 \
            and coordinator is None:
        return False
    if coordinator is None and "WORLD_SIZE" not in os.environ \
            and (num_processes or 0) <= 1:
        return False
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    kind = torch.device(device).type
    if backend is None:
        backend = os.environ.get("WT_DIST_BACKEND") \
            or ("nccl" if kind == "cuda" else "gloo")
    kw = {}
    if coordinator is None:
        init = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and "
                             "--process-id")
        init = coordinator if "://" in coordinator \
            else f"tcp://{coordinator}"
        kw = dict(world_size=int(num_processes), rank=int(process_id))
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for a distributed render on "
                               "the card")
        rank = int(os.environ.get("RANK", process_id or 0))
        torch.cuda.set_device(_local_index(rank))
    dist.init_process_group(
        backend, init_method=init,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return True


def _local_index(rank: int) -> int:
    n = torch.cuda.device_count()
    return int(os.environ.get("LOCAL_RANK", rank)) % max(n, 1)


def world() -> tuple[int, int]:
    """(rank, world size); (0, 1) outside a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def local_device(kind: str = "cuda") -> torch.device:
    """This rank's device: `cuda:{local rank}` (LOCAL_RANK, else the rank,
    modulo the cards on the host), or the CPU."""
    if kind == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", _local_index(world()[0]))


def is_main_process() -> bool:
    """True on the rank that writes outputs (rank 0)."""
    return world()[0] == 0


def sync_hosts():
    """Barrier over every rank (nothing in a single process)."""
    if world()[1] > 1:
        dist.barrier()


def shutdown():
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()
