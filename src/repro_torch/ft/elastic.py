"""The serving side of the JAX package's ``repro/ft/elastic.py``:
:func:`plan_request_rebalance`.  The rest of that module builds JAX
meshes for a run restored onto another device count (``ROADMAP.md`` queue
A item 6)."""

from __future__ import annotations

from typing import Dict


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
