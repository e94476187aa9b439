"""Parameters from the JAX package's models into the port.

* The classifier: the JAX tree is ``{"lstm": {"w_gates", "w_proj"?},
  "fc": {"w"}}``; the port keeps the same layout
  (:func:`params_from_jax`).
* The LM: the JAX ``LM.init`` tree holds ``embed``, ``final_norm``,
  ``lm_head`` (untied only) and ``layers``, whose leaves carry a leading
  ``n_layers`` axis (the reference scans over them); the port keeps one
  dict per layer in a list (:func:`lm_params_from_jax`).

Leaves may be numpy arrays or anything numpy can convert; they become
float32 tensors.  On disk a tree is one ``.npz`` whose keys are the leaf
paths of the JAX layout joined by ``/`` (``lstm/w_gates``,
``layers/attn/wq/w``): :func:`save_npz` writes a JAX tree, and
:func:`load_npz` reads either kind back into the port's params.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(v, device):
    return torch.from_numpy(np.array(v, dtype=np.float32)).to(device)


def params_from_jax(tree, device=None):
    """The port's classifier params from the JAX tree's numpy leaves."""
    lstm = {"w_gates": _leaf(tree["lstm"]["w_gates"], device)}
    if "w_proj" in tree["lstm"]:
        lstm["w_proj"] = _leaf(tree["lstm"]["w_proj"], device)
    return {"lstm": lstm, "fc": {"w": _leaf(tree["fc"]["w"], device)}}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def lm_params_from_jax(tree, device=None):
    """The port's LM params from the JAX ``LM.init`` tree: the stacked
    ``layers`` leaves are split into a list of per-layer dicts."""
    stacked = _map(tree["layers"], np.asarray)
    n_layers = len(next(iter(_flatten(stacked).values())))
    out = {k: _map(v, lambda a: _leaf(a, device))
           for k, v in tree.items() if k != "layers"}
    out["layers"] = [_map(stacked, lambda a, i=i: _leaf(a[i], device))
                     for i in range(n_layers)]
    return out


def _flatten(tree, prefix=""):
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, f"{prefix}{k}/"))
        else:
            flat[prefix + k] = np.asarray(v)
    return flat


def save_npz(path, tree) -> None:
    """Write a JAX-layout tree (nested dicts of numpy-convertible leaves)
    as one ``.npz``."""
    np.savez(path, **_flatten(tree))


def load_npz(path, device=None):
    """Read a tree written by :func:`save_npz` into the port's params: a
    classifier (``lstm``/``fc``) or an LM (``embed``/``layers``)."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *groups, name = key.split("/")
            node = tree
            for g in groups:
                node = node.setdefault(g, {})
            node[name] = z[key]
    if "lstm" in tree:
        return params_from_jax(tree, device)
    if "embed" in tree:
        return lm_params_from_jax(tree, device)
    raise ValueError(f"{path}: neither a classifier tree (lstm/fc) nor an "
                     f"LM tree (embed/layers); keys {sorted(tree)}")
