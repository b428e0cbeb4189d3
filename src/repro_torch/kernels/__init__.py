"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version beside it (``ref.py``) and a wrapper (``ops.py``) that launches the
kernel for CUDA tensors and runs the plain version for CPU tensors.

``LAUNCHES`` counts kernel launches per kernel name: a wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels.

On the ``meta`` device (the dry run, ``launch/dryrun.py``) a wrapper
launches nothing and runs no plain version: it returns empty outputs of the
kernel's shapes and reports the kernel's own work through ``report_meta``
(its analytic FLOPs, the bytes of its operands and outputs) to the sink
``meta_sink`` installed, if any.
"""
from __future__ import annotations

import contextlib

LAUNCHES: dict[str, int] = {}
_META_SINKS: list = []


def count_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def reset_launches() -> None:
    LAUNCHES.clear()


@contextlib.contextmanager
def meta_sink(sink):
    """Send every ``report_meta`` inside the block to ``sink(name, flops,
    nbytes, dtype)``."""
    _META_SINKS.append(sink)
    try:
        yield sink
    finally:
        _META_SINKS.pop()


def report_meta(name: str, flops: float, nbytes: float, dtype) -> None:
    """A kernel's work in a call on the meta device: ``flops`` of
    ``dtype`` and ``nbytes`` moved (each operand read once, each output
    written once).  Not a launch: ``LAUNCHES`` is untouched."""
    if _META_SINKS:
        _META_SINKS[-1](name, float(flops), float(nbytes), dtype)


def nbytes(*tensors) -> int:
    """The bytes of the given tensors (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)
