"""Device lifecycle for the serving engine: the NL-ADC activations a
deployment programs.

The first piece of the JAX package's ``repro/serve/lifecycle.py``:
:func:`analog_activations`, which the engine needs for the snapshot of the
served comparator thresholds that a deployment checkpoint records.  The
aging clock, the INL probes and the re-calibration scheduler
(``RampState``, ``RecalPolicy``, ``RecalScheduler``) are ``ROADMAP.md``
queue A item 4's next slice.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.core.analog_layer import AnalogActivation


def analog_activations(model) -> Dict[str, AnalogActivation]:
    """A model's NL-ADC activations, keyed by attribute name.

    Every model keeps its :class:`AnalogActivation` objects as instance
    attributes (``act``, ``sigmoid_act``, ...); the sort makes the key
    order, and so a checkpoint's tree, deterministic.  Only activations
    that carry a programmed ramp take part.
    """
    out: Dict[str, AnalogActivation] = {}
    for attr in sorted(vars(model)):
        v = getattr(model, attr)
        if isinstance(v, AnalogActivation) and v.ramp is not None \
                and v.ideal_ramp is not None:
            out[attr] = v
    return out
