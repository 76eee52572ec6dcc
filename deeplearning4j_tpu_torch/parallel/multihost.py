"""Multi-process data parallelism over ``torch.distributed`` (the
non-elastic half of the JAX package's ``parallel/multihost.py``).

One process is one rank. Every rank calls :func:`initialize` once, with
the same ``init_method`` (``file://<shared path>`` or
``tcp://<host>:<port>``) and world size and its own rank, then wraps its
net in a trainer:

    from deeplearning4j_tpu_torch.parallel import multihost
    multihost.initialize("tcp://localhost:29500", world_size=2, rank=k,
                         device="cpu")          # device=None: the card
    trainer = multihost.data_parallel_trainer(net)
    trainer.fit_batch(global_batch)   # each rank trains on its rows

The backend follows the device: ``nccl`` for CUDA, ``gloo`` for the CPU.
``backend=`` overrides it (two ranks sharing one card run ``gloo`` on
CUDA tensors: NCCL refuses two ranks on one device). Nothing falls back
from one backend or device to another.

Each rank feeds the same global batch and trains on its
:func:`local_batch_slice` of it. The elastic half (``elastic=True``,
``serve_coordination``) waits for ROADMAP A6.3, and with it the topology
override that re-ranks the survivors of a resize: until then the
``effective_*`` forms are the group's own world and rank. The streaming
input pipeline (``input_pipeline``, ``shard_sources``) waits for A7.6.
"""

from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.device import resolve_device


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, device=None,
               backend: Optional[str] = None,
               timeout_s: float = 300.0, elastic: bool = False) -> str:
    """Bring this process into the default process group (once; a second
    call returns the backend in use). ``device`` picks the backend
    (``None``: the card, raising without one); ``backend`` overrides it.
    A CUDA device with an index (``"cuda:1"``) becomes the current
    device. Returns the backend."""
    if elastic:
        raise NotImplementedError(
            "elastic initialization (ElasticTrainer's runtime) is not "
            "ported yet (ROADMAP A6.3)")
    if dist.is_initialized():
        return dist.get_backend()
    if init_method is None or world_size is None or rank is None:
        raise ValueError("initialize needs init_method, world_size and "
                         "rank: nothing here discovers a cluster")
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=int(world_size),
        rank=int(rank), timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def shutdown() -> None:
    """Leave the default process group (its threads and sockets go)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def runtime_fault_count() -> int:
    """Distributed-runtime faults seen by the elastic client's callback:
    0, as the elastic runtime is not ported (ROADMAP A6.3)."""
    return 0


def process_count() -> int:
    """The default group's world (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


#: the surviving world's count and rank: the group's own until the elastic
#: resize (ROADMAP A6.3) can change it
effective_process_count = process_count
effective_process_index = process_index


def local_batch_slice(global_batch: int) -> slice:
    """This process's rows of a [0, global_batch) range (the per-rank
    input shard)."""
    n = process_count()
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by process count {n}")
    per = global_batch // n
    k = process_index()
    return slice(k * per, (k + 1) * per)


def shard_sources(sources):
    """Waits for the streaming input pipeline (ROADMAP A7.6)."""
    raise NotImplementedError(
        "shard_sources needs datasets/pipeline.py, which is not ported yet "
        "(ROADMAP A7.6)")


def input_pipeline(sources, mesh=None, **kwargs):
    """Waits for the streaming input pipeline (ROADMAP A7.6)."""
    raise NotImplementedError(
        "input_pipeline needs datasets/pipeline.py, which is not ported yet "
        "(ROADMAP A7.6)")


def serve_coordination(port: int, num_processes: int) -> None:
    """The elastic runtime's external coordination service: waits for
    ROADMAP A6.3."""
    raise NotImplementedError(
        "serve_coordination belongs to the elastic runtime, which is not "
        "ported yet (ROADMAP A6.3)")


def data_parallel_trainer(net, n_model: int = 1,
                          gradient_accumulation: int = 1,
                          weight_update_sharding=None,
                          precision=None, tuned=None, device=None,
                          **kwargs):
    """A ``ParallelTrainer`` over the default process group (call
    :func:`initialize` first; without a group it is world 1). ``device``
    defaults to the net's. Every rank then feeds the same global batch to
    ``fit_batch``."""
    from deeplearning4j_tpu_torch.parallel.mesh import MeshContext
    from deeplearning4j_tpu_torch.parallel.trainer import ParallelTrainer
    ctx = MeshContext.create(n_model=n_model,
                             device=device if device is not None
                             else net.device)
    return ParallelTrainer(
        net, ctx, gradient_accumulation=gradient_accumulation,
        weight_update_sharding=weight_update_sharding,
        precision=precision, tuned=tuned, **kwargs)
