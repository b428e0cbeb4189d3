"""Checkpointing, the port of ``src/repro/train/checkpoint.py``: atomic,
async, retention-managed, mesh-independent.

The on-disk format is the reference's, so a checkpoint written by either
package restores in the other: ``step_%09d/arrays.npz`` holds ``arr_i``
in the reference's ``jax.tree.flatten`` leaf order, ``meta.json`` the
step, the leaf count and the time.  The port's training state ``(model,
AdamState)`` is flattened as the reference flattens its ``(params,
AdamState(step, mu, nu, ef_error))``: the model as its
``reference_tree()`` (dict keys sorted, each layer leaf the list of its
per-layer tensors, stacked on a leading ``L`` axis), the optimizer's lists
arranged in the same tree, NamedTuple fields in order.  Writes happen on a
background thread with an atomic rename; ``restore_latest`` skips corrupt
or partial checkpoints.  ``restore`` copies into the state's own tensors
in place, on their device, so an optimizer's lists keep pointing at the
same ``Parameter``s.
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
import time

import numpy as np
import torch
from torch import nn

from repro_torch.train.optimizer import AdamState


def state_tree(state):
    """The reference's tree of ``state``: a model (anything with
    ``reference_tree()``) as that tree; ``(model, AdamState)`` as
    ``(tree, AdamState(step, mu, nu, ef_error))`` with each list (in
    ``model.parameters()`` order) arranged in the model's tree; a dict or
    tuple as given (a tree in the reference's format already, e.g.
    ``train/elastic.py``'s placed leaves)."""
    if isinstance(state, nn.Module):
        return state.reference_tree()
    if (isinstance(state, tuple) and len(state) == 2
            and isinstance(state[0], nn.Module)
            and isinstance(state[1], AdamState)):
        model, opt_state = state
        tree = model.reference_tree()
        params = list(model.parameters())

        def arrange(values):
            by_id = {id(p): v for p, v in zip(params, values)}

            def like(node):
                if isinstance(node, dict):
                    return {k: like(v) for k, v in node.items()}
                if _subtrees(node):
                    return [like(v) for v in node]
                if isinstance(node, list):
                    return [by_id[id(p)] for p in node]
                return by_id[id(node)]
            return like(tree)

        return (tree, AdamState(opt_state.step, arrange(opt_state.mu),
                                arrange(opt_state.nu),
                                arrange(opt_state.ef_error)))
    if isinstance(state, (dict, tuple)):
        return state        # already the reference's tree
    raise TypeError(f"a checkpoint holds a model, (model, AdamState) or "
                    f"the reference's tree, not {type(state).__name__}")


def _subtrees(node) -> bool:
    """A list of sub-trees (a model's list of layers the reference does
    not stack), not the per-layer tensors of one stacked leaf."""
    return isinstance(node, list) and bool(node) and isinstance(node[0],
                                                                dict)


def flatten(tree) -> list:
    """Leaves in ``jax.tree.flatten``'s order: dict keys sorted, tuples
    (NamedTuples too) and lists of sub-trees in order; a list of tensors
    is one leaf (the per-layer tensors of a stacked leaf)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, tuple) or _subtrees(tree):
        return [leaf for node in tree for leaf in flatten(node)]
    return [tree]


def _host(leaf) -> np.ndarray:
    """A leaf as a host array of its own (bf16 as fp32).  A list of
    scalars is one scalar: the reference keeps one per stacked leaf (the
    compression residual while compression is off, zeros)."""
    if isinstance(leaf, list):
        if leaf[0].dim() == 0:
            return _host(leaf[0])
        return np.stack([_host(t) for t in leaf])
    t = leaf.detach()
    if hasattr(t, "full_tensor"):       # a DTensor: gathered on every rank
        t = t.full_tensor()
    dt = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    return t.to("cpu", dt, copy=True).numpy()


def _copy_plan(target, arr: np.ndarray, i: int) -> list:
    """(tensor, array) pairs that write ``arr`` into leaf ``i`` of the
    state; raises if the shapes do not fit."""
    if isinstance(target, list):
        shape = tuple(target[0].shape)
        if arr.shape == (len(target),) + shape:
            return list(zip(target, arr))
        if not shape and arr.shape == ():
            return [(t, arr) for t in target]
        raise ValueError(f"leaf {i}: checkpoint shape {arr.shape}, state "
                         f"{len(target)} x {shape}")
    if tuple(target.shape) != arr.shape:
        raise ValueError(f"leaf {i}: checkpoint shape {arr.shape}, state "
                         f"{tuple(target.shape)}")
    return [(target, arr)]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: queue.Queue = queue.Queue()
        self._async = async_write
        self._err: Exception | None = None
        if async_write:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------ api
    def save(self, step: int, state) -> None:
        """Snapshot the state to host arrays (copies, so later in-place
        updates do not reach them), then write (async by default)."""
        host = [_host(leaf) for leaf in flatten(state_tree(state))]
        if self._async:
            self._q.put((step, host))
        else:
            self._write(step, host)

    def wait(self) -> None:
        if self._async:
            self._q.join()
        if self._err:
            raise self._err

    def restore_latest(self, like):
        """Restore the newest readable checkpoint into ``like`` in place.
        Returns (step, like) or (None, None)."""
        for step in sorted(self.steps(), reverse=True):
            try:
                return step, self.restore(step, like)
            except Exception:      # noqa: BLE001 — corrupt/partial ckpt
                continue
        return None, None

    def restore(self, step: int, like):
        """Copy checkpoint ``step`` into the tensors of ``like`` (every
        leaf read and checked first, so a bad checkpoint changes nothing)
        and return ``like``."""
        path = os.path.join(self.dir, f"step_{step:09d}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            leaves = [z[f"arr_{i}"] for i in range(len(z.files))]
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        targets = flatten(state_tree(like))
        if meta["n_leaves"] != len(targets) or len(leaves) != len(targets):
            raise ValueError(
                f"checkpoint has {meta['n_leaves']} leaves, expected "
                f"{len(targets)}")
        plan = [pair for i, (t, a) in enumerate(zip(targets, leaves))
                for pair in _copy_plan(t, a, i)]
        with torch.no_grad():
            for t, a in plan:
                t.copy_(torch.from_numpy(np.asarray(a)))
        return like

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.match(r"step_(\d+)$", name)
            if m and os.path.exists(os.path.join(self.dir, name, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    # ------------------------------------------------------------- internal
    def _worker(self):
        while True:
            step, host = self._q.get()
            try:
                self._write(step, host)
            except Exception as e:  # noqa: BLE001
                self._err = e
            finally:
                self._q.task_done()

    def _write(self, step: int, leaves: list) -> None:
        final = os.path.join(self.dir, f"step_{step:09d}")
        tmp = final + f".tmp.{os.getpid()}.{int(time.time()*1e6)}"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"arr_{i}": leaf for i, leaf in enumerate(leaves)})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "n_leaves": len(leaves),
                       "time": time.time()}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)       # atomic publish
        self._gc()

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)
