"""repro_torch.dist — the distribution layer on ``torch.distributed``.

The torch twin of the JAX package's ``repro/dist``.  The model is SPMD:
one process per rank, and a ``DeviceMesh`` whose named dims (``pod``,
``data``, ``model``) stand in for the reference's mesh axes.  Code here
is per-rank code over the process groups of those dims, as the
reference's is per-device code inside ``shard_map``:

* :mod:`repro_torch.dist.sharding`    — the layout rules (a spec per
  leaf, a tuple of axis names or ``None`` per dim) for params, batches
  and decode state, and :func:`~repro_torch.dist.sharding.local_shard`,
  which cuts a rank's slice of a full tree by them;
* :mod:`repro_torch.dist.collectives` — the flat and hierarchical
  (reduce-scatter over ``data`` -> all-reduce over ``pod`` -> all-gather
  over ``data``) gradient all-reduce, the autograd-aware collectives of
  the expert-parallel path, and the one place where a gloo group's CUDA
  tensors are staged through host copies;
* :mod:`repro_torch.dist.compress`    — the int8 wire format (blockwise
  shared-scale codes, integer sums) and error feedback;
* :mod:`repro_torch.dist.ep`          — expert-parallel MoE: all-to-all
  dispatch to the experts' owner ranks and back.

No module here touches a process group or a device at import time.
"""
