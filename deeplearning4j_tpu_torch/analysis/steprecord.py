"""The hooks through which a running step reports what it does: the
collectives ``parallel/mesh._collective`` issues, the kernel wrappers'
launches, the optimizer updates, the accumulation microbatches, the
windows of a tBPTT step and the divergence sentinel's drains.

Two kinds of listener read them: shardcheck's record of a step
(``analysis/shardcheck.record_step_program``) and the cost count of a
step (``profiling/cost.counting_step``: the kernels' FLOPs, the
collectives' ring-model bytes). Each subclasses :class:`Listener` and
keeps what it needs. With no listener open each hook costs one list
test. A listener is process-wide: the autograd engine's threads report
into it too."""

from __future__ import annotations

import contextlib

#: the listeners open now
RECORDERS: list = []
_PHASE = {"microbatch": None, "window": None, "drain": False}


class Listener:
    """What a step reports to; every hook does nothing unless a subclass
    keeps it."""

    def note_microbatch(self, index: int) -> None:
        pass

    def note_window(self, index: int) -> None:
        pass

    def note_update(self) -> None:
        pass

    def note_collective(self, kind: str, axis, group_size: int, payload,
                        microbatch, host_buffers: tuple) -> None:
        pass

    def note_launch(self, wrapper: str, impl: str, flops: float,
                    tensors: tuple, microbatch) -> None:
        pass


def recording() -> bool:
    """True while a listener is open."""
    return bool(RECORDERS)


def current_microbatch():
    return _PHASE["microbatch"]


@contextlib.contextmanager
def microbatch(index: int):
    """Within the block the step's ops, collectives and kernel calls
    belong to microbatch ``index`` of its accumulation loop."""
    saved = _PHASE["microbatch"]
    _PHASE["microbatch"] = int(index)
    for rec in RECORDERS:
        rec.note_microbatch(int(index))
    try:
        yield
    finally:
        _PHASE["microbatch"] = saved


def current_window():
    return _PHASE["window"]


@contextlib.contextmanager
def window(index: int):
    """Within the block the step's ops belong to window ``index`` of a
    tBPTT step. Each window is a program of its own, as the reference
    jits one window; what runs between two blocks (the divergence
    sentinel's drain of a window's flag) runs between programs."""
    saved = _PHASE["window"]
    _PHASE["window"] = int(index)
    for rec in RECORDERS:
        rec.note_window(int(index))
    try:
        yield
    finally:
        _PHASE["window"] = saved


def draining() -> bool:
    return _PHASE["drain"]


@contextlib.contextmanager
def drain():
    """Within the block the divergence sentinel reads a step's flags on
    the host (``NetCommonMixin._observe_sentinel``)."""
    saved = _PHASE["drain"]
    _PHASE["drain"] = True
    try:
        yield
    finally:
        _PHASE["drain"] = saved


def note_update() -> None:
    """Called where a step applies one optimizer update."""
    for rec in RECORDERS:
        rec.note_update()


def note_collective(kind: str, axis, group_size: int, payload,
                    host_buffers: tuple = ()) -> None:
    """Called by ``parallel/mesh._collective`` for every collective it
    issues; ``payload`` is the logical full payload, ``host_buffers`` the
    host copies the port stages the collective's tensors through (gloo's
    point-to-point ops on CUDA tensors), empty where it stages none."""
    for rec in RECORDERS:
        rec.note_collective(kind, axis, group_size, payload,
                            _PHASE["microbatch"], tuple(host_buffers))


def note_launch(wrapper: str, impl: str, flops: float, *tensors) -> None:
    """Called by a kernel wrapper where it launches its kernel (``impl=
    "kernel"``) or runs the kernel's plain version (``"plain"``), with the
    kernel's FLOP formula at these shapes and its main inputs."""
    for rec in RECORDERS:
        rec.note_launch(wrapper, impl, float(flops), tensors,
                        _PHASE["microbatch"])
