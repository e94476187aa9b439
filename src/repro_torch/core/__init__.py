"""NL-ADC core: activation registry, ramps, device models, analog layers
and the backend seam."""
