"""Multi-process data parallelism over ``torch.distributed`` (the JAX
package's ``parallel/multihost.py``).

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
:func:`local_batch_slice` of it.

**The elastic half** (``initialize(..., elastic=True)``, the runtime
``resilience/elastic.py``'s ``ElasticTrainer`` runs on). Liveness belongs
to the elastic layer's heartbeat files and bounded step barriers, never
to the runtime, so elastic mode builds a group that a peer's death
cannot take the survivor down with:

- the group's own timeout (``ELASTIC_TIMEOUT_S`` unless given): a
  collective on a dead peer raises (gloo: at once, "Connection closed by
  peer") or gives up after it;
- no watchdog that ends the process: for ``nccl`` the error handling is
  set to abort the communicator and raise (``TORCH_NCCL_ASYNC_ERROR_
  HANDLING=2``, CleanUpOnly; the default 3 ends the process) and the
  watchdog's heartbeat monitor is off, unless the environment says
  otherwise; gloo has no such watchdog;
- every rendezvous epoch joins through a store of its own: a
  ``PrefixStore`` ``dl4j-rdv<epoch>/`` over the ``TCPStore`` of
  ``tcp://``, or the file ``<path>.rdv<epoch>`` of ``file://``, so a
  world restarted after a resize never reads a dead world's keys;
- ``host_service=False`` on every rank joins a ``TCPStore`` that
  :func:`serve_coordination` keeps in a process of its own, so the death
  of any rank, rank 0 included, leaves the store up.

After a resize the survivor's old group is *quarantined*
(:func:`quarantine_group`): nothing issues a collective on it again and
:func:`shutdown` leaves it alone (a step thread may still be inside one
of its collectives). :func:`set_topology_override` installs the
surviving world, which the ``effective_*`` forms, ``local_batch_slice``,
``MeshContext.create`` and the sharded checkpoint's writer read;
:func:`set_rendezvous_epoch` the lease's epoch, which every checkpoint's
topology record carries. The streaming input pipeline
(``input_pipeline``, ``shard_sources``) waits for ROADMAP A7.6.
"""

from __future__ import annotations

import datetime
import logging
import os
import threading
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)

#: an elastic group's timeout (seconds): how long a collective stuck on a
#: peer that neither answers nor closes its sockets may wait
ELASTIC_TIMEOUT_S = 60.0
#: the environment an elastic nccl group starts with (``setdefault``: a
#: value the caller exported wins)
_ELASTIC_NCCL_ENV = {"TORCH_NCCL_ASYNC_ERROR_HANDLING": "2",
                     "TORCH_NCCL_ENABLE_MONITORING": "0",
                     "TORCH_NCCL_DUMP_ON_TIMEOUT": "0"}

_elastic = False
_quarantined = False
#: collective failures seen in elastic mode (``mesh`` records them)
_runtime_faults: List[str] = []
_runtime_faults_lock = threading.Lock()


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, device=None,
               backend: Optional[str] = None,
               timeout_s: Optional[float] = None, elastic: bool = False,
               host_service: Optional[bool] = None,
               rendezvous_epoch: int = 0) -> str:
    """Bring this process into the default process group (once; a second
    call returns the backend in use). ``device`` picks the backend
    (``None``: the card, raising without one); ``backend`` overrides it.
    A CUDA device with an index (``"cuda:1"``) becomes the current
    device. ``timeout_s``: the group's timeout (300 s; elastic:
    ``ELASTIC_TIMEOUT_S``). ``elastic=True`` builds the group for
    ``ElasticTrainer`` (see the module docstring): ``rendezvous_epoch``
    names the store it joins through (the lease's epoch when a resized
    world restarts), ``host_service=False`` on every rank joins the store
    of :func:`serve_coordination` (default: rank 0 hosts it). Returns
    the backend."""
    global _elastic
    if host_service is not None and not elastic:
        raise ValueError(
            "host_service is an elastic-mode knob (an external "
            "coordination store); pass elastic=True, or drop it")
    if dist.is_initialized():
        return dist.get_backend()
    if init_method is None or world_size is None or rank is None:
        raise ValueError("initialize needs init_method, world_size and "
                         "rank: nothing here discovers a cluster")
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    world_size, rank = int(world_size), int(rank)
    if not elastic:
        dist.init_process_group(
            backend, init_method=init_method, world_size=world_size,
            rank=rank, timeout=datetime.timedelta(
                seconds=300.0 if timeout_s is None else timeout_s))
        return backend
    timeout = datetime.timedelta(
        seconds=ELASTIC_TIMEOUT_S if timeout_s is None else timeout_s)
    if backend == "nccl":
        for k, v in _ELASTIC_NCCL_ENV.items():
            os.environ.setdefault(k, v)
    store = _elastic_store(init_method, world_size, rank,
                           rank == 0 if host_service is None
                           else bool(host_service),
                           int(rendezvous_epoch), timeout)
    dist.init_process_group(backend, store=store, world_size=world_size,
                            rank=rank, timeout=timeout)
    _elastic = True
    set_rendezvous_epoch(rendezvous_epoch)
    return backend


def _elastic_store(init_method: str, world_size: int, rank: int,
                   host: bool, epoch: int, timeout):
    """The store rendezvous epoch ``epoch`` joins through."""
    if init_method.startswith("tcp://"):
        hostport = init_method[len("tcp://"):]
        hostname, port = hostport.rsplit(":", 1)
        base = dist.TCPStore(hostname, int(port), world_size,
                             is_master=host, timeout=timeout,
                             wait_for_workers=False)
    elif init_method.startswith("file://"):
        base = dist.FileStore(f"{init_method[len('file://'):]}.rdv{epoch}",
                              world_size)
    else:
        raise ValueError(f"elastic initialize takes a tcp:// or file:// "
                         f"init_method, not {init_method!r}")
    return dist.PrefixStore(f"dl4j-rdv{epoch}/", base)


def elastic_mode() -> bool:
    """True once this process joined its group with ``elastic=True``."""
    return _elastic


def quarantine_group() -> None:
    """Mark the default group as dead to this process (an elastic resize
    left it): nothing issues a collective on it again and ``shutdown``
    does not destroy it."""
    global _quarantined
    _quarantined = True


def group_quarantined() -> bool:
    return _quarantined


def shutdown() -> None:
    """Leave the default process group (its threads and sockets go). A
    quarantined group is left as it is: a step thread may still be inside
    one of its collectives, and it goes with the process."""
    global _elastic
    if dist.is_initialized() and not _quarantined:
        from deeplearning4j_tpu_torch.parallel.mesh import forget_groups
        forget_groups()
        dist.destroy_process_group()
        _elastic = False


def note_runtime_fault(exc: BaseException) -> None:
    """Record a collective that failed in elastic mode (``mesh`` calls
    it; outside elastic mode nothing is recorded)."""
    if not _elastic:
        return
    with _runtime_faults_lock:
        _runtime_faults.append(f"{type(exc).__name__}: {exc}")
    logger.warning("collective failed (elastic mode): %s", exc)


def runtime_fault_count() -> int:
    """Collective failures seen in elastic mode (0 outside it)."""
    with _runtime_faults_lock:
        return len(_runtime_faults)


def process_count() -> int:
    """The default group's world (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


# ---------------------------------------------------------------------------
# effective topology: the resize seam
# ---------------------------------------------------------------------------
# After an elastic resize the surviving world differs from the group's
# (frozen at initialize). What reasons about the per-rank data and
# checkpoint contract (local_batch_slice, MeshContext.create, the sharded
# checkpoint's writer) reads these, so the elastic layer can install the
# survivors' world without a new group.

_topology_override: Optional[Tuple[int, int]] = None   # (count, index)
#: the lease's rendezvous epoch (+1 per membership change), stamped into
#: every checkpoint's topology record; 0 outside elastic runs
_rendezvous_epoch: int = 0


def set_rendezvous_epoch(epoch: int) -> None:
    """Install the current rendezvous epoch (``ElasticTrainer`` at
    bootstrap and on every lease transition)."""
    global _rendezvous_epoch
    _rendezvous_epoch = int(epoch)


def rendezvous_epoch() -> int:
    """The lease's current epoch (0 when not training elastically)."""
    return _rendezvous_epoch


def set_topology_override(count: int, index: int) -> None:
    """Install the post-resize world: ``count`` surviving processes, this
    one at rank ``index``. ``clear_topology_override`` restores the
    group's own view."""
    global _topology_override
    if not 0 <= index < count:
        raise ValueError(f"rank {index} outside world of {count}")
    _topology_override = (int(count), int(index))


def clear_topology_override() -> None:
    global _topology_override
    _topology_override = None


def topology_override() -> Optional[Tuple[int, int]]:
    """The installed (count, index), or None."""
    return _topology_override


def effective_process_count() -> int:
    """The surviving world's process count (the group's until an elastic
    resize installs an override)."""
    if _topology_override is not None:
        return _topology_override[0]
    return process_count()


def effective_process_index() -> int:
    """This process's rank in the surviving world."""
    if _topology_override is not None:
        return _topology_override[1]
    return process_index()


def gloo_collectives_active() -> bool:
    """True when the surviving world's collectives run over gloo. A gloo
    collective on CUDA tensors stages through the host on its own
    threads; a step run in a thread of its own (``ElasticTrainer``)
    synchronizes the card before it counts as done."""
    return (effective_process_count() > 1 and dist.is_initialized()
            and not _quarantined and dist.get_backend() == "gloo")


def local_batch_slice(global_batch: int) -> slice:
    """This process's rows of a [0, global_batch) range (the per-rank
    input shard), in the surviving world."""
    n = effective_process_count()
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by process count {n}")
    per = global_batch // n
    k = effective_process_index()
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
    """Keep the elastic runtime's ``TCPStore`` in a process of its own (no
    training, no device): every rank then calls ``initialize(
    "tcp://<this host>:<port>", ..., elastic=True, host_service=False)``
    and the death of any rank, rank 0 included, leaves the store up.
    Prints ``READY`` once listening and blocks until the process is
    ended; the launcher owns its life."""
    import sys
    import time as _time
    store = dist.TCPStore("localhost", int(port), int(num_processes),
                          is_master=True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=3600))
    print(f"READY coordination store on port {port} for "
          f"{num_processes} processes", flush=True)
    try:
        while True:
            _time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        del store
        print("coordination store shut down", file=sys.stderr, flush=True)


def data_parallel_trainer(net, n_model: int = 1,
                          gradient_accumulation: int = 1,
                          weight_update_sharding=None,
                          precision=None, tuned=None, device=None,
                          **kwargs):
    """A ``ParallelTrainer`` over the default process group (call
    :func:`initialize` first; without a group it is world 1), its mesh
    ``n_model`` ranks wide on the model axis (tensor parallelism) and the
    rest of the world on the data axis. ``device`` defaults to the net's.
    Every rank then feeds the same global batch to ``fit_batch``.
    ``tuned`` (an ``autotune.TunedConfig``) supplies ``n_model`` (its tp
    width) and the knobs left at their defaults; a pipeline plan raises,
    as this flat mesh cannot carry it."""
    from deeplearning4j_tpu_torch.parallel.mesh import MeshContext
    from deeplearning4j_tpu_torch.parallel.trainer import ParallelTrainer
    if tuned is not None:
        if tuned.pp > 1:
            raise ValueError(
                f"TunedConfig plans pp={tuned.pp}; data_parallel_trainer "
                "builds a flat data x model mesh and cannot run a pipeline "
                "schedule (build a PipelineTrainer from tuned.candidate)")
        if n_model == 1:
            n_model = tuned.tp
    ctx = MeshContext.create(n_model=n_model,
                             n_seq=tuned.sp if tuned is not None else 1,
                             device=device if device is not None
                             else net.device)
    if tuned is not None and ctx.world != tuned.device_count:
        logger.warning(
            "TunedConfig was searched for %d rank(s) but the group has %d: "
            "the tuned knobs still apply, but autotune() at this width may "
            "choose differently", tuned.device_count, ctx.world)
    return ParallelTrainer(
        net, ctx, gradient_accumulation=gradient_accumulation,
        weight_update_sharding=weight_update_sharding,
        precision=precision, tuned=tuned, **kwargs)


if __name__ == "__main__":   # pragma: no cover: the store's sidecar CLI
    # python -m deeplearning4j_tpu_torch.parallel.multihost serve <port> <n>
    import sys as _sys
    if len(_sys.argv) == 4 and _sys.argv[1] == "serve":
        serve_coordination(int(_sys.argv[2]), int(_sys.argv[3]))
    else:
        _sys.exit("usage: python -m deeplearning4j_tpu_torch.parallel."
                  "multihost serve <port> <num_processes>")
