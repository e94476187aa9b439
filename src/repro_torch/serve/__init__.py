"""Serving: the batched engine (scan prefill, synchronous steps)."""
