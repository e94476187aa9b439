"""Elastic scaling: the plan of a run restored onto another device
count, its ``DeviceMesh``, and the serving side's request rebalance.

The twin of the JAX package's ``repro/ft/elastic.py``:
:class:`ElasticPlan`, :func:`plan_for_devices` (the largest (data, model)
mesh that fits the surviving ranks, its data axis dividing the global
batch), :func:`build_mesh` (onto ``init_device_mesh``) and
:func:`plan_request_rebalance`.  The reference's ``reshard`` (a host tree
placed onto a new mesh by the layout rules) comes with the production
mesh, ``launch/mesh.py`` (``ROADMAP.md`` queue A item 6's second half);
a rank takes its slice of a tree with
:func:`repro_torch.dist.sharding.local_shard`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from repro_torch.dist.sharding import mesh_shape


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    old_shape: Dict[str, int]
    new_shape: Dict[str, int]
    global_batch: int

    @property
    def new_data_degree(self) -> int:
        return math.prod(v for k, v in self.new_shape.items()
                         if k in ("pod", "data"))

    def local_batch(self, n_hosts: int) -> int:
        if self.global_batch % n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {n_hosts} hosts")
        return self.global_batch // n_hosts


def plan_for_devices(n_devices: int, *, global_batch: int,
                     model_parallel: int = 16,
                     old_mesh=None) -> ElasticPlan:
    """Largest (data, model) mesh that fits the surviving device count.

    Keeps the model axis fixed (halved until it divides the count) and
    shrinks the data axis until it divides the global batch: losing a
    host costs a data replica, never a tensor-parallel shard."""
    model = model_parallel
    while model > 1 and n_devices % model:
        model //= 2
    data = n_devices // model
    while data > 1 and global_batch % data:
        data -= 1
    old_shape = mesh_shape(old_mesh) if old_mesh is not None else {}
    return ElasticPlan(old_shape=old_shape,
                       new_shape={"data": data, "model": model},
                       global_batch=global_batch)


def build_mesh(plan: ElasticPlan, device_type: str = "cpu"):
    """The plan's ``DeviceMesh`` over the first ``data * model`` ranks of
    the default process group (which must be initialized), dims named
    as the plan's.  ``device_type`` picks the groups' backend: ``cpu``
    (gloo) or ``cuda`` (NCCL).  Every rank of the default group calls
    it, those beyond the mesh included (group creation is collective)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    shape = tuple(plan.new_shape.values())
    names = tuple(plan.new_shape.keys())
    if math.prod(shape) == dist.get_world_size():
        return init_device_mesh(device_type, shape, mesh_dim_names=names)
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def plan_request_rebalance(displaced, loads: Dict[str, int]
                           ) -> Dict[str, list]:
    """Assign displaced serving requests to surviving chips, least-loaded
    first.

    A chip pulled for re-program
    (:meth:`repro_torch.serve.engine.ServingEngine.take_queue`) hands its
    queued requests to siblings.  ``loads`` maps chip id -> current load
    (active + queued); each request goes to the momentarily least-loaded
    chip, ties broken by chip id, so a fleet checkpoint replays the same
    assignment.  Returns chip id -> list of requests (every id present,
    possibly empty).
    """
    if not loads:
        raise ValueError("no surviving chips to rebalance onto")
    cur = dict(loads)
    out: Dict[str, list] = {cid: [] for cid in loads}
    for req in displaced:
        cid = min(sorted(cur), key=lambda c: cur[c])
        out[cid].append(req)
        cur[cid] += 1
    return out
