"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version beside it (``ref.py``) and a wrapper (``ops.py``) that launches the
kernel for CUDA tensors and runs the plain version for CPU tensors.

``LAUNCHES`` counts kernel launches per kernel name: a wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels.
"""
from __future__ import annotations

LAUNCHES: dict[str, int] = {}


def count_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def reset_launches() -> None:
    LAUNCHES.clear()
