"""Parameters from the JAX package's models into the port.

* The classifier: the JAX tree is ``{"lstm": {"w_gates", "w_proj"?},
  "fc": {"w"}}``; the port keeps the same layout
  (:func:`params_from_jax`).
* The LM: the JAX ``LM.init`` tree holds ``embed``, ``final_norm``,
  ``lm_head`` (untied only) and ``layers``, whose leaves carry a leading
  ``n_layers`` axis (the reference scans over them); the port keeps one
  dict per layer in a list (:func:`lm_params_from_jax`).  The hybrid
  family's ``groups`` carry a leading ``n_groups`` axis the same way and
  become a list of per-group dicts; its ``tail`` is already a list.
* The encoder-decoder: the JAX ``EncDecLM.init`` tree holds ``embed``,
  ``pos_dec``, ``enc_norm``, ``dec_norm`` and the stacked ``enc_layers``
  and ``dec_layers``, which become lists of per-layer dicts
  (:func:`encdec_params_from_jax`).

Leaves may be numpy arrays or anything numpy can convert; they become
float32 tensors.  On disk a tree is one ``.npz`` whose keys are the leaf
paths of the JAX layout joined by ``/`` (``lstm/w_gates``,
``layers/attn/wq/w``, a list's index as a key: ``tail/0/rec/wx/w``):
:func:`save_npz` writes a JAX tree, and :func:`load_npz` reads either
kind back into the port's params.
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


def _unstack(tree, device):
    """A dict of stacked leaves into a list of per-index dicts."""
    stacked = _map(tree, np.asarray)
    n = len(next(iter(_flatten(stacked).values())))
    return [_map(stacked, lambda a, i=i: _leaf(a[i], device))
            for i in range(n)]


def lm_params_from_jax(tree, device=None):
    """The port's LM params from the JAX ``LM.init`` tree: the stacked
    ``layers`` (or the hybrid's ``groups``) leaves are split into a list
    of per-layer (per-group) dicts; the hybrid's ``tail`` stays a list."""
    out = {k: _map(v, lambda a: _leaf(a, device))
           for k, v in tree.items() if k not in ("layers", "groups", "tail")}
    for key in ("layers", "groups"):
        if key in tree:
            out[key] = _unstack(tree[key], device)
    if "groups" in tree:
        tail = tree.get("tail", [])
        if isinstance(tail, dict):          # read back from an .npz
            tail = [tail[k] for k in sorted(tail, key=int)]
        out["tail"] = [_map(blk, lambda a: _leaf(a, device)) for blk in tail]
    return out


def encdec_params_from_jax(tree, device=None):
    """The port's encoder-decoder params from the JAX ``EncDecLM.init``
    tree: the stacked ``enc_layers`` and ``dec_layers`` leaves are split
    into lists of per-layer dicts; ``embed``, ``pos_dec``, ``enc_norm``
    and ``dec_norm`` are kept as they are."""
    stacked = ("enc_layers", "dec_layers")
    out = {k: _map(v, lambda a: _leaf(a, device))
           for k, v in tree.items() if k not in stacked}
    out.update({k: _unstack(tree[k], device) for k in stacked})
    return out


def _flatten(tree, prefix=""):
    flat = {}
    items = enumerate(tree) if isinstance(tree, (list, tuple)) \
        else tree.items()
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
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
    classifier (``lstm``/``fc``), an encoder-decoder (``enc_layers``) or
    an LM (``embed``/``layers``)."""
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
    if "enc_layers" in tree:
        return encdec_params_from_jax(tree, device)
    if "embed" in tree:
        return lm_params_from_jax(tree, device)
    raise ValueError(f"{path}: neither a classifier tree (lstm/fc) nor an "
                     f"LM tree (embed/layers); keys {sorted(tree)}")
