"""Parameters from the JAX package's classifier into the port.

The JAX classifier's tree is ``{"lstm": {"w_gates", "w_proj"?}, "fc":
{"w"}}`` with numpy (or numpy-convertible) leaves; the port keeps the same
layout, so conversion is a copy into float32 tensors.  On disk the tree is
one ``.npz`` whose keys are the leaf paths joined by ``/``
(``lstm/w_gates``, ``lstm/w_proj``, ``fc/w``).
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device=None):
    """The port's classifier params from the JAX tree's numpy leaves."""
    def leaf(v):
        return torch.from_numpy(np.array(v, dtype=np.float32)).to(device)

    lstm = {"w_gates": leaf(tree["lstm"]["w_gates"])}
    if "w_proj" in tree["lstm"]:
        lstm["w_proj"] = leaf(tree["lstm"]["w_proj"])
    return {"lstm": lstm, "fc": {"w": leaf(tree["fc"]["w"])}}


def save_npz(path, tree) -> None:
    """Write a classifier tree (numpy-convertible leaves) as one ``.npz``."""
    flat = {f"{group}/{name}": np.asarray(v)
            for group, leaves in tree.items() for name, v in leaves.items()}
    np.savez(path, **flat)


def load_npz(path, device=None):
    """Read a tree written by :func:`save_npz` into the port's params."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            group, name = key.split("/", 1)
            tree.setdefault(group, {})[name] = z[key]
    return params_from_jax(tree, device)
