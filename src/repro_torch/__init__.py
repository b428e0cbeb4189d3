"""PyTorch/CUDA port of the GOpt reproduction (``src/repro`` is the JAX
reference it is held against).

Entry point: ``repro_torch.core.gopt.GOpt(store, device=None)`` — the
optimizer plus the binding-table engine over a device-resident torch
operator set.  ``device=None`` means cuda and raises where there is none;
tests pass ``device="cpu"``, which runs every kernel's plain version.
"""
