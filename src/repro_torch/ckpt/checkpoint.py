"""Checkpoints with atomic rename, async save and keep-k GC.

The torch twin of the JAX package's ``repro/ckpt/checkpoint.py``, with
its on-disk layout (one directory per step)::

    <root>/step_00000123.tmp/        (written)
        manifest.json                (leaf paths + dtypes + metadata)
        leaf_00000.npy ...           (one file per tree leaf)
    <root>/step_00000123/            (atomic rename on completion)

A tree is nested dicts (visited in sorted key order), lists and tuples (in
order), named tuples (fields in order, spelled ``.name``) and leaves;
``None`` holds no leaf.  That is JAX's flattening, and each leaf path is
spelled as ``jax.tree_util.keystr`` spells it (``['layers'][0]['k']``),
so either package reads what the other wrote for a tree of the same
structure.  Leaves are tensors (on any device), numpy arrays or Python
numbers; bfloat16 and the float8 types are stored as a same-width
unsigned-int view under their own dtype name, as the reference stores
its ``ml_dtypes`` arrays.  A loaded leaf is written into the template's
own tensor where that has the saved shape and dtype (so a restore holds
no second copy of the tree on the card), and otherwise comes back as a
new tensor on the device of the template's leaf.

A :class:`Stacked` leaf is a list of same-shaped tensors (the port's
per-layer list) stored as one array with a leading axis, which is how the
reference stores its stacked layers: an engine checkpoint of either
package is a tree of the same structure, and a :class:`Stacked` template
leaf is filled slice by slice, in place.

Incomplete ``.tmp`` directories are ignored and garbage-collected, so a
crash mid-save never corrupts the latest valid checkpoint.  The
reference's ``shardings=`` (restore onto another mesh) has no meaning on
one card and is left out.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

# dtype name -> (torch dtype, its same-width signed int view in torch and
# numpy, the unsigned view stored on disk)
_EXOTIC = {
    "bfloat16": (torch.bfloat16, torch.int16, np.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.int8, np.int8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.int8, np.int8, np.uint8),
}
_BY_TORCH = {v[0]: k for k, v in _EXOTIC.items()}


class Stacked:
    """One checkpoint leaf made of ``items``, a list of same-shaped
    tensors: saved as ``torch.stack(items)`` (built on the host, one leaf
    at a time), loaded by copying slice ``i`` into ``items[i]`` where that
    is a tensor of its shape and dtype, else into a new CPU tensor."""

    def __init__(self, items):
        self.items = list(items)

    def host_array(self) -> torch.Tensor:
        return torch.stack([t.detach().cpu() for t in self.items])

    def load(self, saved: torch.Tensor) -> "Stacked":
        if len(saved) != len(self.items):
            raise ValueError(f"stacked leaf of {len(saved)} items loaded "
                             f"into {len(self.items)}")
        return Stacked([_load_into(saved[i], like)
                        for i, like in enumerate(self.items)])


def stack_layers(layers: list):
    """A list of per-layer trees (nested dicts of leaves) as one tree of
    :class:`Stacked` leaves: the reference's stacked layout."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([layer[k] for layer in layers])
                for k in first}
    return Stacked(layers)


def unstack_layers(tree) -> list:
    """The inverse of :func:`stack_layers`: the per-layer trees."""
    if isinstance(tree, dict):
        per_key = {k: unstack_layers(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(tree.items)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path: str = ""):
    """``[(keystr path, leaf)]`` in JAX's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], f"{path}[{k!r}]")]
    if _is_namedtuple(tree):
        return [item for name in tree._fields
                for item in _flatten(getattr(tree, name), f"{path}.{name}")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in order, by
    ``leaves`` (an iterator)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, n), leaves)
                            for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _to_savable(leaf):
    """A host numpy array and its dtype name; the exotic float types as
    their same-width unsigned view."""
    if isinstance(leaf, Stacked):
        leaf = leaf.host_array()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = _BY_TORCH.get(t.dtype)
        if name is not None:
            _, view, _, stored = _EXOTIC[name]
            return t.view(view).numpy().view(stored), name
        arr = t.numpy()
        return arr, arr.dtype.name
    arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _from_saved(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A saved host array as a CPU tensor of its dtype."""
    if dtype_name in _EXOTIC:
        dtype, _, np_signed, _ = _EXOTIC[dtype_name]
        return torch.from_numpy(arr.view(np_signed)).view(dtype)
    return torch.from_numpy(arr if arr.flags.c_contiguous
                            else arr.copy(order="C"))


def _load_into(saved: torch.Tensor, like):
    """``saved`` copied into ``like`` in place where ``like`` is a tensor
    of its shape and dtype (one leaf at a time crosses to the device),
    else a new tensor, on ``like``'s device where that is a tensor; a
    :class:`Stacked` ``like`` takes the slices."""
    if isinstance(like, Stacked):
        return like.load(saved)
    if not isinstance(like, torch.Tensor):
        return saved
    if like.shape == saved.shape and like.dtype == saved.dtype:
        with torch.no_grad():
            like.copy_(saved)
        return like
    return saved.to(like.device)


def _json_default(o):
    """Metadata is caller-supplied; tolerate stray numpy scalars/arrays."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON-serializable: {type(o).__name__}")


def save_checkpoint(root: str, step: int, tree, *,
                    metadata: Optional[Dict] = None) -> str:
    """Synchronous atomic save; returns the final directory."""
    flat = _flatten(tree)
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    dtypes = []
    for i, (_, leaf) in enumerate(flat):
        arr, dtype_name = _to_savable(leaf)
        dtypes.append(dtype_name)
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
    manifest = {"step": step, "paths": [p for p, _ in flat],
                "dtypes": dtypes, "metadata": metadata or {},
                "n_leaves": len(flat)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, default=_json_default)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic validity marker
    return final


def list_checkpoints(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp") \
                and os.path.exists(os.path.join(root, name, "manifest.json")):
            steps.append(int(name[5:]))
    return sorted(steps)


def read_metadata(root: str, *, step: Optional[int] = None):
    """Peek a checkpoint's metadata without loading any leaf: ``(step,
    metadata)`` of ``step`` (default: the latest)."""
    steps = list_checkpoints(root)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {root}")
    step = steps[-1] if step is None else step
    path = os.path.join(root, f"step_{step:08d}", "manifest.json")
    with open(path) as f:
        try:
            manifest = json.load(f)
        except ValueError as e:
            raise ValueError(
                f"{path} is not a checkpoint manifest (malformed JSON: "
                f"{e}); was this directory written by something other "
                "than a checkpoint writer?") from None
    if not isinstance(manifest, dict) or "metadata" not in manifest:
        raise ValueError(
            f"{path} is not a checkpoint manifest (no 'metadata' entry); "
            "train and deployment checkpoints are written by "
            "save_checkpoint — a foreign or hand-edited payload cannot be "
            "restored here")
    return step, manifest["metadata"]


def load_checkpoint(root: str, tree_like, *, step: Optional[int] = None):
    """Restore into the structure of ``tree_like``: ``(tree, step,
    metadata)``.  The leaf paths must equal the saved ones.  A tensor
    leaf of ``tree_like`` with the saved shape and dtype is overwritten
    in place and returned (the restore allocates no second tree on its
    device); any other leaf comes back as a new tensor, on the device of
    ``tree_like``'s leaf where that is a tensor, else on the CPU."""
    steps = list_checkpoints(root)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {root}")
    step = steps[-1] if step is None else step
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _flatten(tree_like)
    paths = [p for p, _ in flat]
    if manifest["paths"] != paths:
        raise ValueError(
            "checkpoint tree mismatch: "
            f"{set(manifest['paths']) ^ set(paths)}")
    loaded = [_load_into(_from_saved(
        np.load(os.path.join(d, f"leaf_{i:05d}.npy")),
        manifest["dtypes"][i]), like) for i, (_, like) in enumerate(flat)]
    return _unflatten(tree_like, iter(loaded)), step, manifest["metadata"]


class CheckpointManager:
    """Async save + keep-k GC + crash-safe resume."""

    def __init__(self, root: str, *, keep: int = 3,
                 save_interval: int = 100):
        self.root = root
        self.keep = keep
        self.save_interval = save_interval
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(root, exist_ok=True)
        self._gc_tmp()

    def _gc_tmp(self):
        for name in os.listdir(self.root):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_interval == 0

    def save(self, step: int, tree, *, metadata: Optional[Dict] = None,
             blocking: bool = False):
        """The device-to-host copy happens on the caller's thread (a
        consistent snapshot, before the next step mutates the tensors in
        place); the file IO runs on a background thread."""
        self.wait()
        snapshot = _unflatten(tree, iter(
            [leaf.detach().to("cpu", copy=True)
             if isinstance(leaf, torch.Tensor)
             else np.array(leaf) for _, leaf in _flatten(tree)]))

        def work():
            try:
                save_checkpoint(self.root, step, snapshot,
                                metadata=metadata)
                self.gc()
            except BaseException as e:     # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        """Join the save in flight; raise the error it met, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            err, self._error = self._error, None
            raise err

    def gc(self):
        steps = list_checkpoints(self.root)
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        steps = list_checkpoints(self.root)
        return steps[-1] if steps else None

    def restore(self, tree_like):
        return load_checkpoint(self.root, tree_like)
