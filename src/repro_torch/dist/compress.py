"""Compressed gradient collectives: the blockwise int8 wire format and
error feedback.

The twin of the JAX package's ``repro/dist/compress.py``, bitwise on the
same inputs.  ``quantize_int8`` flattens a tensor into 2048-element
blocks with one float32 scale per block (symmetric, round half to even,
``|err| <= scale/2``):

* :func:`compressed_psum` — the shared-scale int8 all-reduce: a MAX
  all-reduce of the block scales (an all-zero block offers 0.0, so it
  never coarsens a peer's grid; the 1.0 fill comes after the max, where
  the block is zero on every rank), the codes on that shared grid, an
  int32 sum of the codes, one dequantize.  The reduced value is exact in
  any summation order, so it is bitwise the reference's on the same
  per-rank inputs.
* :func:`ef_compress` — error feedback: the quantization residual rides
  to the next step.
* :func:`compressed_psum_ef` — the two combined: the shared-scale int8
  all-reduce of ``gradient + residual``, returning this rank's new
  residual (what ``--grad-comm int8`` carries in its optimizer state).

The reference's multi-device outputs come from jitted code, where XLA
turns ``amax / 127.0`` into a multiplication by the float32 reciprocal of
127 (3 of 64 blocks of a normal draw differ between the two), so
:func:`block_scales` multiplies by that reciprocal, as the port does for
its kernels' constants.  The eager reference divides.  The division of a
block by its scale is a true division in both.

Functions take a tensor or a tree (nested dicts and lists) and keep its
structure and dtypes; a collective takes the ``DeviceMesh`` and the axes
it reduces over.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.dist import collectives as C
from repro_torch.kernels.ref import fma_f32
from repro_torch.train.optim import tree_map

BLOCK = 2048
_CHUNK = 1 << 24           # elements a float64 pass of the residual takes


def _recip_127(device) -> torch.Tensor:
    return (torch.ones((), dtype=torch.float32)
            / torch.tensor(127.0, dtype=torch.float32)).to(device)


def _blockify(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Flatten + zero-pad to (n_blocks, BLOCK); returns (blocks, pad)."""
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, BLOCK), pad


def _encode(blocks: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Symmetric round-half-to-even int8 codes on the given per-block
    grid."""
    return torch.clamp(torch.round(blocks / scales[:, None]), -127, 127) \
        .to(torch.int8)


def block_scales(blocks: torch.Tensor, zero_fill: float = 1.0
                 ) -> torch.Tensor:
    """Per-block symmetric scale ``amax / 127``; ``zero_fill`` for
    all-zero blocks (:func:`compressed_psum` passes 0.0 before its MAX
    all-reduce)."""
    amax = torch.amax(torch.abs(blocks), dim=-1)
    fill = torch.full_like(amax, zero_fill)
    return torch.where(amax > 0, amax * _recip_127(amax.device), fill)


def quantize_int8(x: torch.Tensor):
    """-> (codes int8 (n_blocks, BLOCK), scales float32 (n_blocks,),
    pad)."""
    blocks, pad = _blockify(x)
    scales = block_scales(blocks)
    return _encode(blocks, scales), scales, pad


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, pad: int,
                    shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scales[:, None]).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def _residual(corrected: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
              pad: int) -> torch.Tensor:
    """``corrected - dequantize(q)`` rounded once: under ``jax.jit`` XLA
    contracts the dequantize's multiply and the subtraction into one
    fused multiply-add.  ``fma_f32`` works in float64, so a leaf goes
    ``_CHUNK`` elements (whole blocks) at a time: its temporaries stay at
    a few chunks, not a few copies of the leaf (an embedding's 0.3 B
    elements)."""
    flat = corrected.reshape(-1)
    codes = q.reshape(-1)
    out = torch.empty_like(flat)
    for i in range(0, flat.numel(), _CHUNK):
        n = min(_CHUNK, flat.numel() - i)
        steps = scales[i // BLOCK:(i + n + BLOCK - 1) // BLOCK] \
            .repeat_interleave(BLOCK)[:n]
        out[i:i + n] = fma_f32(-codes[i:i + n].to(torch.float32), steps,
                               flat[i:i + n])
    return out.reshape(corrected.shape)


def ef_init(g: Any) -> Any:
    """A zero float32 error-feedback residual of ``g``'s structure."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), g)


def _ef_one(g: torch.Tensor, res: torch.Tensor):
    corrected = g.to(torch.float32) + res
    q, s, pad = quantize_int8(corrected)
    approx = dequantize_int8(q, s, pad, g.shape)
    return approx.to(g.dtype), _residual(corrected, q, s, pad)


def ef_compress(g: Any, res: Any) -> Tuple[Any, Any]:
    """(g + residual) -> the int8 grid; returns (approx, new residual)."""
    out = tree_map(lambda a, b: _ef_one(a, b), g, res)
    return (tree_map(lambda _, o: o[0], g, out),
            tree_map(lambda _, o: o[1], g, out))


def _shared_scales(blocks: torch.Tensor, mesh, axes) -> torch.Tensor:
    shared = C.pmax(block_scales(blocks, zero_fill=0.0), mesh, axes)
    return torch.where(shared > 0, shared, torch.ones_like(shared))


def _compressed_psum_one(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    blocks, pad = _blockify(x)
    scales = _shared_scales(blocks, mesh, axes)
    total = C.psum(_encode(blocks, scales).to(torch.int32), mesh, axes)
    return dequantize_int8(total, scales, pad, x.shape).to(x.dtype)


def compressed_psum(x: Any, mesh, axes) -> Any:
    """The shared-scale int8 all-reduce of ``x`` (a tensor or a tree)
    over ``axes`` of ``mesh``.  Exact for all-zero inputs and on a
    one-rank axis (the local grid is then the shared grid, within
    scale/2)."""
    return tree_map(lambda g: _compressed_psum_one(g, mesh, axes), x)


def _compressed_psum_ef_one(x: torch.Tensor, res: torch.Tensor, mesh, axes):
    corrected = x.to(torch.float32) + res
    blocks, pad = _blockify(corrected)
    scales = _shared_scales(blocks, mesh, axes)
    codes = _encode(blocks, scales)
    total = C.psum(codes.to(torch.int32), mesh, axes)
    reduced = dequantize_int8(total, scales, pad, x.shape).to(x.dtype)
    # each rank carries its own quantization error (against its own
    # dequantized codes): the reduced value is the sum of the ranks'
    # dequantized codes, so the total error is the sum of the residuals
    return reduced, _residual(corrected, codes, scales, pad)


def compressed_psum_ef(x: Any, res: Any, mesh, axes) -> Tuple[Any, Any]:
    """The shared-scale int8 all-reduce of ``x + res`` with error
    feedback; ``res`` is this rank's residual tree from the previous step
    (:func:`ef_init` for step 0).  Returns ``(reduced, new_res)``.  The
    sum over steps of ``reduced`` plus the sum over ranks of the last
    residual is the sum over steps and ranks of ``x``: no gradient mass
    is lost."""
    out = tree_map(lambda a, b: _compressed_psum_ef_one(a, b, mesh, axes),
                   x, res)
    return (tree_map(lambda _, o: o[0], x, out),
            tree_map(lambda _, o: o[1], x, out))

