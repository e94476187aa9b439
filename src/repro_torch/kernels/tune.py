"""Per-shape launch configs for the hand-written CUDA kernels: a JSON cache
and their resolution at every call.

The twin of the JAX package's ``repro/kernels/tune.py``, with its names and
contract (a cache keyed by kernel, shape, dtype, platform and mode; an
override > cache > default precedence; a sweep that fills the cache) but
not its TPU cost model.  A tuple names a CUDA kernel's launch config:

====================  =====================  ================================
kernel                tuple                  meaning
====================  =====================  ================================
fused_matmul_nladc    (rows, cols, k_tile)   M <= 8 (the GEMV): rows of x
                                             per block (1, 2, 4 or 8),
                                             output columns per block (32
                                             or 64: one or two a lane), K
                                             columns of x staged in shared
                                             memory at a time (a power of
                                             two, 16 to 2048)
  M > 8               (rows, cols, stages)   the tensor-core GEMM: rows of x
                                             a tile (64 or 128), output
                                             columns a tile (64 or 128: one
                                             or two consumer warpgroups),
                                             TMA ring stages at most (2, 3
                                             or 4; as many run as fit)
  the expert gate     (rows, cols, k_tile)   capacity rows per work item (1,
                                             2, 4 or 8), columns per weight
                                             strip (128 or 256), K rows per
                                             TMA ring stage (16, 32 or 64)
analog_tile           (rows, cols, k_tile)   rows of x per work item (4, 8
                                             or 16), columns per strip (32
                                             or 64), K rows per TMA ring
                                             stage (16, 32, 64 or 128)
nladc                 (rows, cols)           rows in flight per CTA (one a
                                             warp: 4, 8 or 16; clipped to
                                             M), columns per CTA (32, 64,
                                             128 or 256)
lstm_gates            (rows, threads)        batch rows a thread takes (1, 2
                                             or 4), threads a CTA may use (a
                                             multiple of 32, at most 512):
                                             row groups x a strip of
                                             columns covering groups x rows
                                             batch rows
====================  =====================  ================================

Every config of a kernel computes the same bits: the SIMT matmul kernels
keep their K split fixed (16 warps, warp w summing k = w, w + 16, ... in
order, the partial sums added in warp order), the tensor-core GEMM sums
each output's K in increasing 32-row steps whatever its tile or ring, no
config above changes either, and the elementwise kernels compute each
element on its own.  The sweep checks it: each candidate's output digest
must equal the default config's.

* :class:`TuneCache` -- best configs per shape, JSON (``version`` 1), keyed
  ``kernel|MxKxN|dtype|platform|mode``: the platform is ``sm_90`` (from the
  card's compute capability) or ``cpu``, the mode ``compiled`` on the card
  and ``plain`` on the CPU (where the wrappers take the plain versions).
* :func:`resolve_blocks` -- the config of one call.  Precedence:

      1. an explicit override (:func:`set_block_overrides`,
         :func:`configure`, ``--kernel-blocks``);
      2. the ``REPRO_TORCH_KERNEL_BLOCKS`` env var;
      3. the active cache (:func:`set_active_cache`, ``--kernel-cache``);
      4. the cache at the ``REPRO_TORCH_KERNEL_CACHE`` env var's path;
      5. the kernel's current constants (:data:`DEFAULT_BLOCKS`;
         :data:`EXPERT_GATE_BLOCKS` for the grouped expert gate,
         :data:`GEMM_BLOCKS` for the dense gate at M > 8): a miss launches
         the kernel's default config (:func:`default_for`).

  The env vars carry the port's prefix, as ``REPRO_TORCH_BACKEND`` does, so
  a process that imports both packages never shares them with ``repro``.
  The JAX package resolves once per trace; the port resolves at every
  call, so the result is memoized per (kernel, shape, dtype, device): a
  call costs one dict lookup, no torch op and no device sync.  The memo
  is cleared by :func:`configure`, :func:`set_active_cache` and
  :func:`set_block_overrides`; the env vars are read when a key is first
  resolved (reading them at every call would double its host cost), so a
  process that changes one calls :func:`configure` after it.
* :func:`launch_config` -- the resolved tuple made one the kernel can
  launch (:func:`supported`); a tuple that had to change raises a one-time
  :class:`KernelBlockClampWarning` and is noted on the active cache.  At
  M > 8 the dense gate's tuple means the GEMM's (rows, cols, stages): a
  tuple of the GEMV's meaning (rows <= 8), as a cache from before the GEMM
  holds for such shapes, is rejected for the GEMM's default with the same
  one-time warning; any other tuple is clamped.
* :func:`autotune` / :func:`autotune_kernel` -- the sweep.  On the card
  (``measure="wall"``) every candidate runs on seeded inputs and is timed
  by device time per call after a warm-up (:func:`device_us`: the
  profiler's kernel time, the clock ``chip_smoke.py`` reports; CUDA events
  where three profiler sessions record nothing, or where a reading falls
  under the launch floor, which no launch beats); on the CPU (``"proxy"``)
  candidates are ranked by a deterministic static score, so the cache
  bytes repeat.  A candidate that fails to launch, or computes other bits,
  fails the sweep.

The grouped expert gate (``fused_matmul_nladc.moe_fused_matmul``) resolves
``fused_matmul_nladc`` at its per-expert ``(C, K, N)``, as the JAX
package's vmapped gate does; the sweep times such an entry as the grouped
launch over its experts (``experts`` > 0), which is what it configures.
Its kernel reads the tuple with its own meaning (the table above), its
own default and its own rules: the wrapper and the sweep name it by one
argument, ``experts`` > 0, to :func:`launch_config`, :func:`supported`,
:func:`candidates` and :func:`proxy_score`.  So an entry written for the
earlier grouped kernel (32 or 64 columns, K tiles up to 2048) still loads
and is clamped, with the one-time warning, to the config nearest it.  The
dense gate's two kernels are told apart by the shape alone: M above
:data:`GEMV_MAX_ROWS` is the GEMM's (its space, default and rules, through
``shape`` to :func:`supported` and the shape to the others).
"""

from __future__ import annotations

import json
import os
import statistics
import warnings
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

ENV_BLOCKS = "REPRO_TORCH_KERNEL_BLOCKS"
ENV_CACHE = "REPRO_TORCH_KERNEL_CACHE"

# the cache-miss configs: the kernels' launch constants before this seam,
# and for the crossbar tile (redesigned since) the config that is fast at
# the PTB gate crossbar without slowing the small shapes on an H100
DEFAULT_BLOCKS: Dict[str, Tuple[int, ...]] = {
    "fused_matmul_nladc": (4, 32, 512),
    "analog_tile": (16, 32, 128),
    "nladc": (8, 32),
    "lstm_gates": (1, 256),
}
# moe_fused_matmul: 8 capacity rows, a 128-column strip, 64 K rows a stage
EXPERT_GATE_BLOCKS = (8, 128, 64)
# fused_matmul_nladc takes its GEMV for M <= GEMV_MAX_ROWS and its
# tensor-core GEMM above: the shape picks the kernel, no config does
GEMV_MAX_ROWS = 8
# the GEMM's (x rows a tile, output columns a tile, ring stages at most)
GEMM_BLOCKS = (128, 128, 4)
_GEMM_ROWS, _GEMM_COLS, _GEMM_STAGES = (64, 128), (64, 128), (2, 3, 4)

_MATMUL_ROWS = {"fused_matmul_nladc": (1, 2, 4, 8), "analog_tile": (4, 8, 16)}
_MATMUL_COLS = (32, 64)
_K_TILES = {"fused_matmul_nladc": tuple(2 ** i for i in range(4, 12)),
            "analog_tile": (16, 32, 64, 128)}    # x staged / a ring stage
_NLADC_ROWS, _NLADC_COLS = (4, 8, 16), (32, 64, 128, 256)
_LSTM_ROWS, _LSTM_THREADS_MAX = (1, 2, 4), 512
_GATE_ROWS, _GATE_COLS, _GATE_K_TILES = (1, 2, 4, 8), (128, 256), (16, 32, 64)

# the sweep's candidate values per tuple position
_CAND_K_TILE = {"fused_matmul_nladc": (256, 512, 1024),
                "analog_tile": (32, 64, 128)}
_CAND_NLADC = ((4, 8, 16), (32, 64, 128))
_CAND_LSTM = ((1, 2, 4), (128, 256, 512))
_SMS = 132                           # H100 SXM, for the proxy score only


class KernelBlockClampWarning(UserWarning):
    """A requested launch config was changed to one the kernel takes."""


def tunable_kernels() -> Tuple[str, ...]:
    return tuple(sorted(DEFAULT_BLOCKS))


def default_blocks(kernel: str) -> Tuple[int, ...]:
    """The kernel's launch constants: the cache-miss fallback."""
    try:
        return DEFAULT_BLOCKS[kernel]
    except KeyError:
        raise KeyError(f"unknown tunable kernel {kernel!r}; "
                       f"known: {sorted(DEFAULT_BLOCKS)}") from None


def _gemm(kernel: str, shape, experts: int = 0) -> bool:
    """Whether ``shape`` takes the dense gate's tensor-core GEMM."""
    return (kernel == "fused_matmul_nladc" and not experts
            and shape is not None and int(shape[0]) > GEMV_MAX_ROWS)


def default_for(kernel: str, shape=None, experts: int = 0
                ) -> Tuple[int, ...]:
    """The default config of the kernel that ``shape`` launches: the
    expert gate's with ``experts`` > 0, the GEMM's for the dense gate at
    M > 8, else :func:`default_blocks`."""
    if experts and kernel == "fused_matmul_nladc":
        return EXPERT_GATE_BLOCKS
    if _gemm(kernel, shape):
        return GEMM_BLOCKS
    return default_blocks(kernel)


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------

def default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _device(device) -> torch.device:
    return default_device() if device is None else torch.device(device)


def platform(device=None) -> str:
    """``sm_<major><minor>`` of a CUDA device, else the device type."""
    device = _device(device)
    if device.type == "cuda":
        major, minor = torch.cuda.get_device_capability(device)
        return f"sm_{major}{minor}"
    return device.type


def backend_mode(device=None) -> str:
    """``compiled`` where the wrappers launch kernels, ``plain`` where they
    take the plain versions (the CPU)."""
    return "compiled" if _device(device).type == "cuda" else "plain"


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def cache_key(kernel: str, shape: Sequence[int], dtype=torch.float32,
              plat: Optional[str] = None, mode: Optional[str] = None,
              device=None) -> str:
    shape_s = "x".join(str(int(d)) for d in shape)
    return "|".join([kernel, shape_s, dtype_name(dtype),
                     plat or platform(device), mode or backend_mode(device)])


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

class TuneCache:
    """Best-per-shape launch configs, JSON-serializable.

    ``entries`` maps :func:`cache_key` strings to dicts with at least
    ``{"blocks": [...]}`` plus how they were chosen (``source``, ``us`` or
    ``score``, ``clamped``).
    """

    def __init__(self, entries: Optional[Dict[str, dict]] = None,
                 meta: Optional[dict] = None):
        self.entries: Dict[str, dict] = dict(entries or {})
        self.meta = dict(meta or {})

    def to_dict(self) -> dict:
        return {"version": 1, "meta": self.meta,
                "entries": {k: self.entries[k]
                            for k in sorted(self.entries)}}

    @classmethod
    def from_dict(cls, d: dict) -> "TuneCache":
        if isinstance(d, dict) and "entries" not in d and \
                isinstance(d.get("tune"), dict):
            d = d["tune"]   # a kernel_tune result file wraps the cache
        if not isinstance(d, dict) or "entries" not in d:
            raise ValueError("not a kernel tune cache (no 'entries' key)")
        if d.get("version", 1) != 1:
            raise ValueError(f"unsupported tune-cache version "
                             f"{d.get('version')!r}")
        return cls(entries=d["entries"], meta=d.get("meta", {}))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "TuneCache":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def lookup(self, kernel: str, shape: Sequence[int], dtype=torch.float32,
               device=None) -> Optional[Tuple[int, ...]]:
        e = self.entries.get(cache_key(kernel, shape, dtype, device=device))
        if e is None:
            return None
        return tuple(int(b) for b in e["blocks"])

    def record(self, kernel: str, shape: Sequence[int], dtype,
               blocks: Sequence[int], *, device=None, **extra) -> dict:
        e = {"kernel": kernel, "shape": [int(d) for d in shape],
             "blocks": [int(b) for b in blocks]}
        e.update(extra)
        self.entries[cache_key(kernel, shape, dtype, device=device)] = e
        return e

    def note_clamp(self, kernel: str, shape: Sequence[int], dtype,
                   requested: Sequence[int], clamped: Sequence[int],
                   device=None) -> None:
        """Annotate (creating if needed) the entry for a clamped call."""
        key = cache_key(kernel, shape, dtype, device=device)
        e = self.entries.setdefault(
            key, {"kernel": kernel, "shape": [int(d) for d in shape],
                  "blocks": [int(b) for b in clamped], "source": "clamp"})
        e["clamped"] = {"requested": [int(b) for b in requested],
                        "applied": [int(b) for b in clamped]}


# ---------------------------------------------------------------------------
# Active cache, overrides and the memo
# ---------------------------------------------------------------------------

_ACTIVE: Optional[TuneCache] = None
_ACTIVE_FROM_ENV: Tuple[str, Optional[TuneCache]] = ("", None)
_OVERRIDES: Dict[str, Tuple[int, ...]] = {}
_ENV_OVERRIDES: Tuple[str, Dict[str, Tuple[int, ...]]] = ("", {})
_WARNED: set = set()
_MEMO: Dict[tuple, Tuple[int, ...]] = {}      # resolve_blocks
_LAUNCH: Dict[tuple, Tuple[int, ...]] = {}    # launch_config


def _clear_memo() -> None:
    _MEMO.clear()
    _LAUNCH.clear()


def set_active_cache(cache: Optional[TuneCache]) -> None:
    """Install (or clear with ``None``) the process-wide tune cache."""
    global _ACTIVE
    _ACTIVE = cache
    _clear_memo()


def active_cache() -> Optional[TuneCache]:
    """The explicit cache, else the ``REPRO_TORCH_KERNEL_CACHE`` one."""
    global _ACTIVE_FROM_ENV
    if _ACTIVE is not None:
        return _ACTIVE
    path = os.environ.get(ENV_CACHE, "")
    if not path:
        return None
    if _ACTIVE_FROM_ENV[0] != path:
        _ACTIVE_FROM_ENV = (path, TuneCache.load(path))
    return _ACTIVE_FROM_ENV[1]


def parse_block_spec(spec: str) -> Dict[str, Tuple[int, ...]]:
    """``"fused_matmul_nladc=4x64x512,nladc=8x32"`` -> overrides.

    Extents are separated by ``x``, kernels by commas; each kernel takes as
    many extents as its tuple has (3 for the matmul kernels, 2 for the
    elementwise ones), all positive.
    """
    out: Dict[str, Tuple[int, ...]] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if "=" not in part:
            raise ValueError(f"--kernel-blocks entry {part!r} is not "
                             f"KERNEL=AxBxC form")
        kernel, _, vals = part.partition("=")
        kernel = kernel.strip()
        if kernel not in DEFAULT_BLOCKS:
            raise ValueError(f"unknown tunable kernel {kernel!r}; "
                             f"known: {sorted(DEFAULT_BLOCKS)}")
        blocks = tuple(int(v) for v in vals.strip().split("x"))
        want = len(DEFAULT_BLOCKS[kernel])
        if len(blocks) != want or any(b <= 0 for b in blocks):
            raise ValueError(
                f"{kernel} takes {want} positive block extents, got {vals!r}")
        out[kernel] = blocks
    return out


def set_block_overrides(spec: str) -> None:
    """Install per-kernel forced configs (the ``--kernel-blocks`` CLI)."""
    parsed = parse_block_spec(spec)
    _OVERRIDES.clear()
    _OVERRIDES.update(parsed)
    _clear_memo()


def clear_block_overrides() -> None:
    _OVERRIDES.clear()
    _clear_memo()


def _env_overrides() -> Dict[str, Tuple[int, ...]]:
    global _ENV_OVERRIDES
    spec = os.environ.get(ENV_BLOCKS, "")
    if _ENV_OVERRIDES[0] != spec:
        _ENV_OVERRIDES = (spec, parse_block_spec(spec) if spec else {})
    return _ENV_OVERRIDES[1]


def configure(blocks_spec: str = "", cache_path: str = "") -> None:
    """One-call CLI hookup (``--kernel-blocks`` / ``--kernel-cache``);
    also clears the memo, so the env vars are read again."""
    if blocks_spec:
        set_block_overrides(blocks_spec)
    if cache_path:
        set_active_cache(TuneCache.load(cache_path))
    _clear_memo()


def _resolve(kernel, shape, dtype, device, default) -> Tuple[int, ...]:
    ov = _OVERRIDES.get(kernel) or _env_overrides().get(kernel)
    if ov is not None:
        return ov
    cache = active_cache()
    if cache is not None:
        hit = cache.lookup(kernel, shape, dtype, device)
        if hit is not None:
            return hit
    return default if default is not None else default_blocks(kernel)


def resolve_blocks(kernel: str, shape: Sequence[int], dtype=torch.float32,
                   device=None, *, default=None) -> Tuple[int, ...]:
    """The launch config of one call (see the module docstring for the
    precedence); ``default`` replaces the kernel's constants on a miss.
    Memoized per (kernel, shape, dtype, device, default)."""
    key = (kernel, tuple(shape), dtype, device, default)
    hit = _MEMO.get(key)
    if hit is None:
        hit = _MEMO[key] = _resolve(kernel, key[1], dtype, device, default)
    return hit


def _floor_choice(v: int, choices: Sequence[int]) -> int:
    below = [c for c in choices if c <= v]
    return max(below) if below else min(choices)


def _floor_multiple(v: int, unit: int, top: int) -> int:
    return min(max(unit, v // unit * unit), top)


def supported(kernel: str, blocks: Sequence[int], experts: int = 0, *,
              shape=None) -> Tuple[int, ...]:
    """The launch config nearest ``blocks`` that the kernel takes: each
    extent rounded down to a value it has (a template instance, a power of
    two or a multiple of 32) and into its range.  ``experts`` > 0: the
    grouped expert gate's rules; a dense gate ``shape`` with M > 8: the
    GEMM's."""
    blocks = tuple(int(b) for b in blocks)
    if _gemm(kernel, shape, experts):
        rows, cols, stages = blocks
        return (_floor_choice(rows, _GEMM_ROWS),
                _floor_choice(cols, _GEMM_COLS),
                _floor_choice(stages, _GEMM_STAGES))
    if experts and kernel == "fused_matmul_nladc":
        rows, cols, k_tile = blocks
        return (_floor_choice(rows, _GATE_ROWS),
                _floor_choice(cols, _GATE_COLS),
                _floor_choice(k_tile, _GATE_K_TILES))
    if kernel in _MATMUL_ROWS:
        rows, cols, k_tile = blocks
        return (_floor_choice(rows, _MATMUL_ROWS[kernel]),
                _floor_choice(cols, _MATMUL_COLS),
                _floor_choice(k_tile, _K_TILES[kernel]))
    if kernel == "nladc":
        rows, cols = blocks
        return (_floor_choice(rows, _NLADC_ROWS),
                _floor_choice(cols, _NLADC_COLS))
    if kernel == "lstm_gates":
        rows, threads = blocks
        return (_floor_choice(rows, _LSTM_ROWS),
                _floor_multiple(threads, 32, _LSTM_THREADS_MAX))
    raise KeyError(f"unknown tunable kernel {kernel!r}")


def launch_config(kernel: str, shape: Tuple[int, ...], dtype, device,
                  blocks=None, *, experts: int = 0) -> Tuple[int, ...]:
    """What a wrapper launches: ``blocks`` if given, else
    :func:`resolve_blocks`, made :func:`supported`, a change warning once.
    ``experts`` > 0: the grouped expert gate over that many experts at the
    per-expert ``shape`` (its default :data:`EXPERT_GATE_BLOCKS` and its
    rules).  The dense gate at M > 8: the GEMM's default and rules, and a
    GEMV tuple (rows <= 8) is rejected for the GEMM's default.  Memoized
    like :func:`resolve_blocks`; ``shape`` is a tuple of ints."""
    if blocks is not None:
        blocks = tuple(blocks)
    gate = bool(experts)
    key = (kernel, shape, dtype, device, blocks, gate)
    cfg = _LAUNCH.get(key)
    if cfg is None:
        default = default_for(kernel, shape, experts)
        raw = blocks if blocks is not None else resolve_blocks(
            kernel, shape, dtype, device, default=default)
        if _gemm(kernel, shape, experts) and raw[0] <= GEMV_MAX_ROWS:
            cfg = default
            warn_clamp(kernel, shape, raw, cfg, dtype, device,
                       "rejected (a GEMV config: at M > 8 a tuple is the "
                       "GEMM's (rows, cols, stages)) for the GEMM's default")
        else:
            cfg = supported(kernel, raw, experts, shape=shape)
            if cfg != raw:
                warn_clamp(kernel, shape, raw, cfg, dtype, device)
        _LAUNCH[key] = cfg
    return cfg


def warn_clamp(kernel: str, shape: Sequence[int], requested: Sequence[int],
               clamped: Sequence[int], dtype=torch.float32,
               device=None, what: str = "clamped to") -> None:
    """One-time warning (per kernel x shape x request) on a clamped (or
    rejected) config; the applied config is also noted on the active
    cache, so a re-recorded cache ships the config that ran."""
    key = (kernel, tuple(int(d) for d in shape),
           tuple(int(b) for b in requested))
    if key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(
            f"{kernel}: requested launch config {tuple(requested)} {what} "
            f"{tuple(clamped)} for shape {tuple(shape)}: tune this shape "
            f"(python -m repro_torch.launch.kernel_tune) or pass a config "
            f"the kernel takes", KernelBlockClampWarning, stacklevel=3)
    cache = active_cache()
    if cache is not None:
        cache.note_clamp(kernel, shape, dtype, requested, clamped, device)


def _reset_for_tests() -> None:
    """Clear all module state (tests only)."""
    global _ACTIVE, _ACTIVE_FROM_ENV, _ENV_OVERRIDES
    _ACTIVE = None
    _ACTIVE_FROM_ENV = ("", None)
    _ENV_OVERRIDES = ("", {})
    _OVERRIDES.clear()
    _WARNED.clear()
    _clear_memo()


# ---------------------------------------------------------------------------
# Autotune sweep
# ---------------------------------------------------------------------------

def candidates(kernel: str, shape: Sequence[int],
               experts: int = 0) -> List[Tuple[int, ...]]:
    """The sweep's configs for one shape, the default among them.  Rows
    past the smallest value that covers the shape, and K tiles past the
    smallest that covers the shape's K, would repeat a config's work and
    are left out.  ``experts`` > 0: the expert gate's configs (its own
    rules and default); the dense gate at M > 8: the GEMM's."""
    def upto(values, size):
        cover = [v for v in values if v >= size]
        return sorted({v for v in values if v < size} |
                      ({min(cover)} if cover else set()))

    if _gemm(kernel, shape, experts):
        m, k, n = shape
        cands = {(r, c, s) for r in upto(_GEMM_ROWS, m)
                 for c in upto(_GEMM_COLS, n) for s in _GEMM_STAGES}
        return sorted(cands | {GEMM_BLOCKS})
    if experts and kernel == "fused_matmul_nladc":
        m, k, n = shape
        cands = {(r, c, t) for r in upto(_GATE_ROWS, m)
                 for c in upto(_GATE_COLS, n) for t in _GATE_K_TILES}
        return sorted(cands | {EXPERT_GATE_BLOCKS})
    if kernel in _MATMUL_ROWS:
        m, k, n = shape
        rows = upto(_MATMUL_ROWS[kernel], m)
        cols = upto(_MATMUL_COLS, n)
        tiles = _K_TILES[kernel]
        whole = min(t for t in tiles if t >= min(k, tiles[-1]))
        k_tiles = sorted({min(t, whole) for t in _CAND_K_TILE[kernel]})
        cands = {(r, c, t) for r in rows for c in cols for t in k_tiles}
    else:
        m, n = shape
        grid = _CAND_NLADC if kernel == "nladc" else _CAND_LSTM
        cands = {(r, c) for r in upto(grid[0], m) for c in upto(grid[1], n)}
    cands.add(default_blocks(kernel))
    return sorted(cands)


def proxy_score(kernel: str, shape: Sequence[int], blocks: Sequence[int],
                experts: int = 0) -> float:
    """A deterministic static score (lower is better) for the CPU sweep:
    the bytes the launch moves (the weight once per row block, x once per
    column block; the elementwise tensor with its padding) times a small
    per-block and per-K-tile overhead.  Not a performance claim: the card
    times the candidates.  ``experts`` > 0 scores the expert gate's work
    items over that many experts, walked by one CTA per SM; the dense gate
    at M > 8 its GEMM's tiles (w read once per row tile, x once per column
    tile)."""
    if experts and kernel == "fused_matmul_nladc":
        m, k, n = shape
        rows, cols, k_tile = blocks
        row_blocks, strips = -(-m // rows), -(-n // cols)
        moved = 4.0 * experts * (row_blocks * k * strips * cols
                                 + strips * row_blocks * rows * k)
        items = experts * row_blocks * strips
        rounds = -(-items // _SMS)
        return moved * (1.0 + 0.01 * rounds) * (1.0 + 0.01 * -(-k // k_tile))
    if _gemm(kernel, shape):
        m, k, n = shape
        rows, cols, stages = blocks
        row_tiles, col_tiles = -(-m // rows), -(-n // cols)
        moved = row_tiles * 4.0 * k * n + col_tiles * 2.0 * k * m
        waves = -(-(row_tiles * col_tiles) // _SMS)
        return moved * (1.0 + 0.01 * waves) * (1.0 + 0.01 / stages)
    if kernel in _MATMUL_ROWS:
        m, k, n = shape
        rows, cols, k_tile = blocks
        row_blocks, col_blocks = -(-m // rows), -(-n // cols)
        moved = 4.0 * (row_blocks * k * col_blocks * cols
                       + col_blocks * row_blocks * rows * k)
        steps = -(-k // k_tile)
        grid = row_blocks * col_blocks
    else:
        m, n = shape
        rows, cols = blocks
        grid = -(-m // rows) * -(-n // cols)
        moved = 4.0 * grid * rows * cols
        steps = 1
    waves = -(-grid // _SMS)
    return moved * (1.0 + 0.01 * waves) * (1.0 + 0.01 * steps)


def digest(*tensors) -> str:
    """crc32 of the tensors' bytes as float32 (as the JAX sweep's)."""
    crc = 0
    for t in tensors:
        a = t.detach().float().contiguous().cpu().numpy()
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return f"{crc:08x}"


def kernel_inputs(kernel: str, shape: Sequence[int], dtype, device,
                  seed: int = 0, experts: int = 0) -> tuple:
    """Seeded inputs of one sweep call, made as the JAX sweep makes them
    (a 5-bit swish ramp; sigmoid and tanh for the LSTM tail): the wrapper's
    positional arguments.  ``analog_tile`` runs without noise or PWM, as
    the JAX sweep calls it; ``fused_matmul_nladc`` with ``experts`` > 0 is
    the grouped expert gate over that many ``shape`` slabs."""
    from repro_torch.core.nladc import build_ramp
    from repro_torch.kernels.ref import closed_form_params

    rng = np.random.default_rng(seed)

    def put(a, dt=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(device, dt)

    def ramp_tensors(name):
        ramp = build_ramp(name, 5)
        return ramp, put(np.asarray(ramp.thresholds)), \
            put(np.asarray(ramp.y_table))

    if kernel in _MATMUL_ROWS:
        m, k, n = shape
        lead = (experts,) if experts else ()
        x = put(rng.normal(0, 0.4, (*lead, m, k)), dtype)
        w = put(rng.normal(0, 0.2, (*lead, k, n)))
        ramp, thr, y_table = ramp_tensors("swish")
        if experts:
            return x, w, thr, y_table
        if kernel == "fused_matmul_nladc":
            return x, w, None, thr, y_table
        return x, w, None, thr, closed_form_params(ramp)
    if kernel == "nladc":
        m, n = shape
        _, thr, y_table = ramp_tensors("swish")
        return put(rng.normal(0, 2, (m, n)), dtype), thr, y_table
    if kernel == "lstm_gates":
        b, h = shape
        _, s_thr, s_y = ramp_tensors("sigmoid")
        _, t_thr, t_y = ramp_tensors("tanh")
        g = put(rng.normal(0, 1.5, (b, 4 * h)))
        c = put(rng.normal(0, 0.5, (b, h)))
        return g, c, s_thr, s_y, t_thr, t_y
    raise KeyError(kernel)


def kernel_fn(kernel: str, experts: int = 0):
    """The wrapper a sweep calls, taking its config as a keyword:
    ``fn(*kernel_inputs(...), blocks=...)``."""
    from repro_torch.kernels import analog_tile as at
    from repro_torch.kernels import fused_matmul_nladc as fmn
    from repro_torch.kernels import lstm_cell
    from repro_torch.kernels import nladc as nk

    if kernel == "fused_matmul_nladc":
        return fmn.moe_fused_matmul if experts else fmn.fused_matmul_nladc
    if kernel == "analog_tile":
        return lambda x, w, nz, thr, dec, blocks=None: at.analog_tile(
            x, w, thr, dec, w_noise=nz, blocks=blocks)
    if kernel == "nladc":
        return lambda x, thr, y, blocks=None: nk.nladc(x, thr, y,
                                                       block=blocks)
    if kernel == "lstm_gates":
        return lambda *a, blocks=None: lstm_cell.lstm_gates(*a, block=blocks)
    raise KeyError(kernel)


def events_us(fn, calls: int = 20) -> float:
    """µs per call of ``fn`` by CUDA events around ``calls`` back-to-back
    calls (host gaps between launches count)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return 1e3 * start.elapsed_time(end) / calls


def device_us(fn, *, calls: int = 20, tries: int = 3,
              floor_us: float = 0.0) -> Tuple[float, str]:
    """Device time per call of ``fn`` in µs after a warm-up, from
    ``torch.profiler``: each kernel's median time over the events the
    session recorded, times its launches per call (its event count over
    ``calls``, rounded), summed.  On the H100 the profiler, once a process
    has run a few dozen sessions, drops one or two of a session's 20 events
    and now and then records an event with a broken duration: a plain sum
    over ``calls`` read up to 5% low, and one case half its time.  After
    ``tries`` sessions without a device event, CUDA events around
    back-to-back calls (:func:`events_us`).  A profiler reading under
    ``floor_us`` (the launch floor, or the least time the work can take)
    cannot be right: CUDA events time the call instead.  Returns the time
    and the clock (``"profiler"``, ``"cuda_events"``, or
    ``"cuda_events: profiler read <us> under <floor_us>"``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels: Dict[str, List[float]] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                kernels.setdefault(e.name, []).append(e.self_device_time_total)
        us = sum(statistics.median(d) * round(len(d) / calls)
                 for d in kernels.values())
        if us >= floor_us and us > 0:
            return us, "profiler"
        if us > 0:
            return (events_us(fn, calls),
                    f"cuda_events: profiler read {us:.4g} under "
                    f"{floor_us:.4g}")
    return events_us(fn, calls), "cuda_events"


def autotune_kernel(kernel: str, shape: Sequence[int], dtype=torch.float32,
                    *, cache: TuneCache, measure: Optional[str] = None,
                    device=None, experts: int = 0, calls: int = 20,
                    floor_us: float = 0.0) -> dict:
    """Sweep the candidates of one kernel x shape and record the winner.

    ``measure``: ``"wall"`` runs every candidate on the card, holds its
    output digest to the default config's (a mismatch or a failed launch
    raises) and times it (:func:`device_us`, a reading under ``floor_us``
    timed again by CUDA events); ``"proxy"`` ranks by
    :func:`proxy_score`.  ``None`` takes ``"wall"`` on a CUDA device and
    ``"proxy"`` on the CPU.  ``experts`` > 0 sweeps the grouped expert
    gate over that many per-expert ``shape`` slabs, from its own default.
    The entry records the default config and, on the card, its time beside
    the winner's.
    """
    device = _device(device)
    if measure is None:
        measure = "wall" if device.type == "cuda" else "proxy"
    if measure == "wall" and device.type != "cuda":
        raise ValueError("measure='wall' times the card; it needs a CUDA "
                         "device")
    shape = tuple(int(d) for d in shape)
    default = default_for(kernel, shape, experts)
    cands = sorted(set(candidates(kernel, shape, experts)) | {default})
    extra = {"default": list(default), "candidates": len(cands)}
    if experts:
        extra["experts"] = experts
    if measure == "wall":
        fn = kernel_fn(kernel, experts)
        args = kernel_inputs(kernel, shape, dtype, device, experts=experts)
        want = digest(*as_tuple(fn(*args, blocks=default)))
        timed = {}
        for blocks in cands:
            got = digest(*as_tuple(fn(*args, blocks=blocks)))
            if got != want:
                raise RuntimeError(
                    f"{kernel} {shape}: config {blocks} computes digest "
                    f"{got}, the default {default} {want}")
            timed[blocks] = device_us(lambda b=blocks: fn(*args, blocks=b),
                                      calls=calls, floor_us=floor_us)
        best = min(cands, key=lambda b: (timed[b][0], b))
        extra.update(source="measured", us=timed[best][0],
                     default_us=timed[default][0], digest=want,
                     timed_by=sorted({t[1] for t in timed.values()}))
    else:
        scores = {b: proxy_score(kernel, shape, b, experts) for b in cands}
        best = min(cands, key=lambda b: (scores[b], b))
        extra.update(source="proxy", score=scores[best],
                     default_score=scores[default])
    return cache.record(kernel, shape, dtype, best, device=device, **extra)


def as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def shape_entries(shape_list, dtype=torch.float32):
    """``[(shape, dtype, experts), ...]`` from a list of shapes, each a
    tuple of ints (taking ``dtype``, no experts), ``(shape, dtype)`` or
    ``(shape, dtype, experts)``."""
    out = []
    for s in shape_list:
        if isinstance(s[0], (tuple, list)):
            out.append((tuple(s[0]), s[1], s[2] if len(s) > 2 else 0))
        else:
            out.append((tuple(s), dtype, 0))
    return out


def autotune(shapes: Dict[str, Iterable], dtype=torch.float32, *,
             cache: Optional[TuneCache] = None,
             measure: Optional[str] = None, device=None,
             calls: int = 20) -> TuneCache:
    """Sweep ``{kernel: [shape, (shape, dtype) or (shape, dtype,
    experts), ...]}`` into a (new or given) cache.  On the card every
    reading under the launch floor (:func:`launch_floor_us`) is timed again
    by CUDA events."""
    device = _device(device)
    if cache is None:
        meta = {"platform": platform(device),
                "backend_mode": backend_mode(device)}
        if device.type == "cuda":
            meta["device_name"] = torch.cuda.get_device_name(device)
        cache = TuneCache(meta=meta)
    wall = (measure or ("wall" if device.type == "cuda" else "proxy")) \
        == "wall"
    floor = launch_floor_us(device) if wall else 0.0
    for kernel, shape_list in sorted(shapes.items()):
        for shape, dt, experts in shape_entries(shape_list, dtype):
            autotune_kernel(kernel, shape, dt, cache=cache, measure=measure,
                            device=device, experts=experts, calls=calls,
                            floor_us=floor)
    return cache


def launch_floor_us(device) -> float:
    """Device µs of one launch of the one-block kernel that writes one word
    (``kernels/launch_floor.py``), by the profiler: no launch takes less."""
    from repro_torch.kernels.launch_floor import launch_floor

    word = torch.zeros(1, dtype=torch.int32, device=device)
    return device_us(lambda: launch_floor(word))[0]
