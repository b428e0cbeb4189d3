"""Roofline terms of one step, counted on the meta device: the port of
``src/repro/launch/roofline.py``.

The reference parses XLA's optimized HLO; the port runs eagerly and has no
HLO, so it counts the step as it runs.  ``Counter`` is a
``TorchDispatchMode`` over one run of the step on ``meta`` (nothing is
allocated or computed):
- FLOPs of every aten op that ``torch.utils.flop_counter`` has a formula
  for (mm, bmm, addmm, baddbmm, convolutions, SDPA), plus each hand-written
  kernel's own analytic count, which its wrapper reports from its meta
  branch (``kernels.report_meta``) instead of running its plain version;
- memory traffic at every non-view aten op: the bytes of its tensor
  operands and outputs (the port runs eagerly, so every op is a boundary;
  allocations such as ``empty`` move nothing), plus each kernel's operand
  and output bytes;
- the high-water mark of live tensor storage the run creates (an estimate
  of the temporaries: a storage counts from the op that makes it to the
  collection of its tensor).

Collective bytes are what the shardings imply, not what a run moves (the
port has no SPMD partitioner): in a training step, ZeRO-1's
reduce-scatter of each gradient leaf across the data-parallel axes and the
all-gather of the updated parameter (an all-reduce where the optimizer
state of a leaf is not split), each at the leaf's per-device bytes.
Tensor-parallel activation traffic is not counted.

Terms (NVIDIA H100 SXM5 80 GB,
https://www.nvidia.com/en-us/data-center/h100/):
    T_compute    = flops_per_device / peak (989e12 dense bf16/fp16;
                   67e12 fp32, TF32 being off in the port), per dtype
    T_memory     = bytes_per_device / 3.35e12 (HBM3)
    T_collective = collective_bytes_per_device / 450e9 (NVLink, per
                   direction)
"""
from __future__ import annotations

import collections
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels

PEAK_FLOPS_BF16 = 989e12     # dense bf16 / fp16 tensor cores
PEAK_FLOPS_FP32 = 67e12      # fp32 (TF32 off)
HBM_BW = 3.35e12             # bytes/s per device
NVLINK_BW = 450e9            # bytes/s per device, each direction

# allocations and views whose schemas carry no alias annotation: no bytes
# move
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "lift_fresh", "alias",
               "_unsafe_view"}


def peak_flops(dtype) -> float:
    return (PEAK_FLOPS_BF16 if dtype in (torch.bfloat16, torch.float16)
            else PEAK_FLOPS_FP32)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class Counter(TorchDispatchMode):
    """FLOPs by dtype, bytes, kernel work and the live-storage high-water
    mark of everything run inside the block."""

    def __init__(self):
        super().__init__()
        self.flops = collections.defaultdict(float)     # dtype -> flops
        self.bytes = 0.0
        self.kernels: dict = {}
        self.live = 0
        self.peak_live = 0
        self._sink = None

    def __enter__(self):
        self._sink = kernels.meta_sink(self._kernel)
        self._sink.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._sink.__exit__(*exc)
        return out

    def _kernel(self, name, flops, nbytes, dtype):
        self.flops[dtype] += flops
        self.bytes += nbytes
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def _track(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        self.live += n
        self.peak_live = max(self.peak_live, self.live)
        weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if packet in flop_registry:
            self.flops[ins[0].dtype] += flop_registry[packet](
                *args, **kwargs, out_val=out)
        name = packet.__name__.split(".")[-1]
        if name not in _NO_TRAFFIC and not _is_view(func):
            outs = [t for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins + outs)
            if not func._schema.is_mutable:
                for t in outs:
                    self._track(t)
        elif name.startswith("empty") or name.startswith("new_empty"):
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self._track(t)
        return out

    def total_flops(self) -> float:
        return sum(self.flops.values())

    def compute_seconds(self) -> float:
        """The FLOPs of each dtype at that dtype's peak, summed."""
        return sum(f / peak_flops(d) for d, f in self.flops.items())


@dataclasses.dataclass
class RooflineTerms:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_breakdown: dict = dataclasses.field(default_factory=dict)
    n_collectives: int = 0
    peak_flops: float = PEAK_FLOPS_BF16   # flops / the per-dtype time
    kernels: dict = dataclasses.field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / NVLINK_BW

    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "bytes": self.bytes,
            "collective_bytes": self.collective_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant(),
            "collectives": self.collective_breakdown,
            "peak_flops": self.peak_flops,
            "kernels": self.kernels,
        }


def terms_of(counter: Counter, devices: int = 1) -> RooflineTerms:
    """Per-device terms of a counted run of the whole (global) step: its
    work split evenly over ``devices``."""
    flops = counter.total_flops()
    t = counter.compute_seconds()
    return RooflineTerms(
        flops=flops / devices, bytes=counter.bytes / devices,
        peak_flops=flops / t if t else PEAK_FLOPS_BF16,
        kernels={k: {n: (v / devices if n != "calls" else v)
                     for n, v in rec.items()}
                 for k, rec in counter.kernels.items()})


def zero1_collectives(terms: RooflineTerms, param_specs, param_shardings,
                      mu_shardings, dp_size: int) -> RooflineTerms:
    """Add a training step's ZeRO-1 collectives to ``terms``: per
    parameter leaf (records and shardings in the reference's tree
    format), a reduce-scatter of its gradient and an all-gather of the
    updated leaf where its first moment is split over the data axes, else
    an all-reduce of its gradient; each at the leaf's per-device bytes."""
    from repro_torch.configs.base import tree_leaves as leaves
    if dp_size <= 1:
        return terms
    for leaf, ps, ms in zip(leaves(param_specs), leaves(param_shardings),
                            leaves(mu_shardings)):
        shard = ps.shard_shape(leaf.shape)
        nbytes = torch.Size(shard).numel() * torch.empty(
            (), dtype=leaf.dtype).element_size()
        split = any("data" in names
                    for names in ms.axis_names(len(leaf.shape)))
        kinds = (("reduce-scatter", "all-gather") if split
                 else ("all-reduce",))
        for kind in kinds:
            terms.collective_breakdown[kind] = (
                terms.collective_breakdown.get(kind, 0.0) + nbytes)
            terms.collective_bytes += nbytes
            terms.n_collectives += 1
    return terms


def summarize(terms: RooflineTerms, model_flops_per_chip: float) -> dict:
    d = terms.as_dict()
    d["model_flops_per_chip"] = model_flops_per_chip
    d["useful_flops_ratio"] = (model_flops_per_chip / terms.flops
                               if terms.flops else 0.0)
    t_bound = max(terms.t_compute, terms.t_memory, terms.t_collective)
    d["roofline_fraction"] = (
        (model_flops_per_chip / terms.peak_flops) / t_bound
        if t_bound else 0.0)
    return d
