"""Per-chip energy accounting priced by :mod:`repro_torch.core.hwcost`.

The JAX package's ``repro/obs/energy.py``.  The reference walks its
stacked param tree, where one layer leaf is one macro of count
``n_layers``; the port's LM keeps one dict per layer (per hybrid group)
in a list, and :func:`_macro_shapes` prices that list as the stacked
leaves it stands for (the reference's keys, shapes, counts and order),
and the hybrid's ``tail``, a list in both packages, block by block, so
``variants`` and ``n_macros`` are the reference's to the bit.  Only
shapes are read: ``device="meta"`` tensors price a model that was never
allocated.

The paper's headline is area/energy/throughput efficiency of the in-memory
NL-ADC; this module turns the serving stack's token counters into **costed
efficiency numbers** — tokens-per-joule and TOPS/W — instead of leaving
``core.hwcost`` an unused calculator.

A :class:`ChipEnergyModel` prices one served model by walking its param
tree: every weight matrix leaf is a crossbar macro of ``(rows, cols)``
(leading axes = stacked layer instances), priced per invocation under two
periphery variants:

* ``nladc``        — this work: crossbar MAC + in-memory NL-ADC ramp +
                     comparator periphery (:func:`hwcost.nladc_macro`),
                     with one extra ramp column per threshold bank
                     (``bank_cols``) and the Supp. S11 redundancy factor
                     scaling the ramp-array write energy;
* ``digital_lut``  — a NEON-style digital baseline (arXiv 2211.05730):
                     conventional ramp ADC + digital LUT activation
                     (:func:`hwcost.digital_lut_macro`).

Embedding/norm/bias leaves are excluded (lookups and vector ops are not
crossbar MACs).  One *processed token* (a prefill position or a decode
step of one slot) costs one invocation of every macro — the same
single-token recurrence the paper's system tables price.

Calibration anchors (see ``hwcost.CALIBRATION_TARGETS``): the 65 nm
NL-CIM LSTM macro (arXiv 2512.06362) publishes 33.6–136.2 TOPS/W for the
analog path; the NEON digital baseline lands at single-digit TOPS/W.  The
per-arch numbers this module emits are checked against those brackets in
the JAX package's ``tests/test_obs.py``.

The :class:`EnergyMeter` accumulates processed/generated token counts
(into the deployment's metrics registry, so the counters checkpoint and
restore with the engine) and reports ``tokens_per_joule`` / ``tops_per_w``
per variant plus the nladc-vs-digital efficiency ratio.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

from repro_torch.core import hwcost as HW

# param-leaf path fragments that are NOT crossbar MAC macros
_EXCLUDE = ("embed", "norm", "bias", "scale")


# the params keys whose list the reference stacks on a leading axis: the
# LM's ``layers``, or the hybrid's ``groups`` (its ``tail`` is a list there)
_STACKED = ("layers", "groups")


def _stacked_leaves(tree, path: str = ""):
    """``[(keystr path, shape)]`` in JAX's flattening order (dict keys
    sorted).  The list under a top-level key of :data:`_STACKED` (one tree
    per layer or group) stands for the stacked tree: its first item's
    leaves under the list's own path, each shape with the list's length in
    front.  Any other list is walked by index, as ``keystr`` spells it
    (``['tail'][0]``)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            sub = f"{path}[{k!r}]"
            v = tree[k]
            if not path and k in _STACKED and isinstance(v, (list, tuple)) \
                    and v:
                out += [(p, (len(v),) + s)
                        for p, s in _stacked_leaves(v[0], sub)]
            else:
                out += _stacked_leaves(v, sub)
        return out
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _stacked_leaves(v, f"{path}[{i}]")]
    return [(path, tuple(getattr(tree, "shape", ())))]


def _macro_shapes(params) -> Dict[str, tuple]:
    """``keystr -> (count, rows, cols)`` for every crossbar weight leaf."""
    out = {}
    for key, shape in _stacked_leaves(params):
        if len(shape) < 2 or min(shape[-2:]) < 2:
            continue
        if any(x in key.lower() for x in _EXCLUDE):
            continue
        count = int(math.prod(shape[:-2])) if len(shape) > 2 else 1
        out[key] = (count, int(shape[-2]), int(shape[-1]))
    return out


class ChipEnergyModel:
    """Per-token energy/ops price of one served model, both variants."""

    def __init__(self, variants: Dict[str, dict], *, bits: int,
                 bank_cols: int, redundancy: int, n_macros: int):
        self.variants = variants          # name -> {e_per_token_pj, ...}
        self.bits = bits
        self.bank_cols = bank_cols
        self.redundancy = redundancy
        self.n_macros = n_macros

    @classmethod
    def price(cls, params, *, bits: int = 5, bank_cols: int = 0,
              redundancy: int = 1) -> "ChipEnergyModel":
        """Price every crossbar macro in ``params`` under both peripheries.

        ``bank_cols`` > 0 deploys one NL-ADC ramp column per col-tile of
        ``bank_cols`` output columns (the PR-5 threshold-bank layout) —
        more ramp columns, more conversion parallelism, priced as extra
        ``n_nladc_cols``.  ``redundancy`` is the Supp. S11 copy count R;
        the losing R-1 ramp copies are programmed but held off the read
        path, so only the ramp-array energy scales with R.
        """
        shapes = _macro_shapes(params)
        totals = {"nladc": {"e_pj": 0.0, "e_periph_pj": 0.0, "ops": 0},
                  "digital_lut": {"e_pj": 0.0, "e_periph_pj": 0.0,
                                  "ops": 0}}
        for count, rows, cols in shapes.values():
            n_banks = max(1, math.ceil(cols / bank_cols)) if bank_cols \
                else 1
            nl = HW.nladc_macro(rows, cols, bits_in=bits, bits_out=bits,
                                n_nladc_cols=n_banks)
            ramp_e = next(m.energy_pj for m in nl.modules
                          if m.name == "NL-ADC array")
            nl_periph = sum(m.energy_pj for m in nl.modules
                            if m.name in ("NL-ADC array", "Comparator",
                                          "Ripple counter"))
            dig = HW.digital_lut_macro(rows, cols, bits_in=bits,
                                       bits_out=bits)
            dig_periph = sum(m.energy_pj for m in dig.modules
                             if m.name in ("Ramp-ADC", "Ripple counter",
                                           "Processor"))
            totals["nladc"]["e_pj"] += count * (
                nl.energy_pj + (redundancy - 1) * ramp_e)
            totals["nladc"]["e_periph_pj"] += count * (
                nl_periph + (redundancy - 1) * ramp_e)
            totals["nladc"]["ops"] += count * nl.n_mac_ops
            totals["digital_lut"]["e_pj"] += count * dig.energy_pj
            totals["digital_lut"]["e_periph_pj"] += count * dig_periph
            totals["digital_lut"]["ops"] += count * dig.n_mac_ops
        variants = {
            name: {"e_per_token_pj": t["e_pj"],
                   "e_periphery_pj": t["e_periph_pj"],
                   "ops_per_token": t["ops"],
                   # ops / pJ == TOPS/W exactly (see hwcost.MacroCost)
                   "tops_per_w": (t["ops"] / t["e_pj"]) if t["e_pj"]
                   else 0.0}
            for name, t in totals.items()}
        return cls(variants, bits=bits, bank_cols=bank_cols,
                   redundancy=redundancy, n_macros=len(shapes))

    def to_dict(self) -> dict:
        return {"bits": self.bits, "bank_cols": self.bank_cols,
                "redundancy": self.redundancy, "n_macros": self.n_macros,
                "variants": {k: dict(v) for k, v in self.variants.items()}}


class EnergyMeter:
    """Token-priced energy counters for one chip.

    Counts ride in the deployment's :class:`~repro_torch.obs.metrics
    .MetricsRegistry` (names ``energy.processed_tokens``,
    ``energy.generated_tokens``, ``energy.<variant>_pj``), so they
    checkpoint/restore with the engine and export over Prometheus like
    every other metric.
    """

    def __init__(self, model: ChipEnergyModel, metrics, *,
                 chip: Optional[str] = None):
        self.model = model
        labels = {"chip": chip} if chip else {}
        self._processed = metrics.counter("energy.processed_tokens",
                                          **labels)
        self._generated = metrics.counter("energy.generated_tokens",
                                          **labels)
        self._e = {name: metrics.counter(f"energy.{name}_pj", **labels)
                   for name in model.variants}

    def add_processed(self, n: int) -> None:
        """``n`` forward positions ran (prefill tokens or decode slots):
        every crossbar macro fired once per position."""
        if n <= 0:
            return
        self._processed.inc(n)
        for name, v in self.model.variants.items():
            self._e[name].inc(n * v["e_per_token_pj"])

    def add_generated(self, n: int) -> None:
        if n > 0:
            self._generated.inc(n)

    def report(self) -> dict:
        """Costed efficiency: per-variant joules, tokens/J, TOPS/W."""
        gen = self._generated.value
        out = {"processed_tokens": int(self._processed.value),
               "generated_tokens": int(gen)}
        for name, v in self.model.variants.items():
            e_j = self._e[name].value * 1e-12
            out[name] = {
                "energy_j": e_j,
                "tokens_per_joule": (gen / e_j) if e_j > 0 else 0.0,
                "tops_per_w": v["tops_per_w"],
            }
        nl, dig = out.get("nladc"), out.get("digital_lut")
        if nl and dig and dig["energy_j"] > 0:
            out["nladc_vs_digital_energy"] = \
                nl["energy_j"] / dig["energy_j"]
        return out
