"""Exact nodal analysis of the parasitic crossbar network (the IR oracle).

The wordline/bitline resistance network that
:func:`repro_torch.core.crossbar.line_drop` approximates in closed form,
solved exactly: the oracle the correction is held to, never a step-time
path.  The topology is the reference's:

* wordline ``i`` is a chain of ``n_cols`` nodes ``W[i, :]`` with wire
  conductance ``g_wl = 1/r_wl`` per segment; a voltage source drives the
  chain through one segment at the left (``sourcing="single"``) or through
  one segment at each end (``"double"``);
* bitline ``j`` is a chain of ``n_rows`` nodes ``B[:, j]`` with ``g_bl``
  per segment, ended below the last row by one segment into the virtual
  ground of the transimpedance amplifier (0 V);
* cell ``(i, j)`` is a conductance ``g[i, j]`` between ``W[i, j]`` and
  ``B[i, j]``; column ``j``'s output is the current through its TIA
  segment, ``g_bl * B[n_rows - 1, j]``.

Conductances are in µS and drives in volts, so currents come out in µA.
The network is linear: ``exact_effective_conductances`` (the currents of a
unit drive on each wordline alone) gives ``y = x @ G_eff`` for any x.

**Solver.**  The reference factorizes the KCL matrix with scipy's sparse
LU.  At the paper's 633x512 tile that is 648,192 unknowns an array, too
many for a dense factorization, so this port solves in float64 torch on
an explicit device by preconditioned conjugate gradients, matrix-free.
The matrix is symmetric positive definite (a weighted graph Laplacian
plus the driver and TIA legs to ground).  Its wire conductances (10^6 µS
at 1 ohm) dwarf a cell's (at most 150 µS), so the preconditioner solves
each wordline chain and each bitline chain exactly with its own cells on
the diagonal (block Jacobi: one Cholesky factor per chain, batched,
computed once), and only the cells couple the two blocks.  Each branch
current is computed from its own voltage difference, so the residual
keeps the digits a sum of 10^6-µS terms would cancel; CG rounds (each
cutting the residual ``CG_REDUCE`` times) repeat on the recomputed
residual (iterative refinement) until it stops falling.  A solve must
end with its KCL imbalance ``max |b - A v|`` at most :meth:`NodalSystem.
tolerance`, ``RTOL`` of the largest wire current ``g_wire * max(1,
max|x|)`` (10^-8 µA at 1 ohm: a float64 voltage of 1 V moves a wire's
current by ~2e-10 µA an ulp), or it raises.  ``check_residual`` also
holds it to the reference's ``1e-6 * max(1, max g * max |x|)`` µA.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core.crossbar import GAMMA_US, W_CLIP

RTOL = 1e-14       # KCL imbalance over the largest wire current, g_wl*|x|
CG_REDUCE = 1e-10  # a CG round's residual reduction
MAX_ROUNDS = 6     # CG rounds on the recomputed residual
MAX_ITER = 2000    # iterations of one round
_ROWS_PER_SOLVE = 64   # unit drives solved at once for G_eff


def _wire_conductance_us(r_ohm: float) -> float:
    if r_ohm <= 0.0:
        raise ValueError(
            "the nodal oracle needs r > 0 (r = 0 is the ideal network; "
            "the closed-form correction handles it as the identity)")
    return 1e6 / r_ohm  # ohm -> µS


def _chain(n: int, g_wire: float, ends: tuple, device) -> torch.Tensor:
    """Wire Laplacian of a chain of ``n`` nodes, (n, n) float64, with one
    more leg to ground at each node of ``ends`` (a driver or the TIA)."""
    deg = torch.zeros(n, dtype=torch.float64, device=device)
    if n > 1:
        deg[:-1] += g_wire
        deg[1:] += g_wire
    for e in ends:
        deg[e] += g_wire
    off = torch.full((n - 1,), -g_wire, dtype=torch.float64, device=device)
    return torch.diag(deg) + torch.diag(off, 1) + torch.diag(off, -1)


class NodalSystem:
    """The KCL system of one crossbar: preconditioner factored once, then
    solved per drive.

    ``A @ v = b(x)`` with ``v = [W.ravel(), B.ravel()]`` the node voltages
    and ``b`` the driver injections ``g_wl * x_i`` at the sourced wordline
    ends.  ``x`` is ``(n_rows,)`` or a batch ``(k, n_rows)``.  After each
    solve ``iterations`` and ``residual_ua`` (the largest KCL imbalance of
    the batch, µA) say how it went.
    """

    def __init__(self, g_us, r_wl_ohm: float, r_bl_ohm: float,
                 sourcing: str = "single", *, device="cuda"):
        g = torch.as_tensor(g_us, dtype=torch.float64, device=device)
        if g.ndim != 2:
            raise ValueError(f"g_us must be 2D, got shape {tuple(g.shape)}")
        if bool((g < 0).any()):
            raise ValueError("cell conductances must be >= 0")
        if sourcing not in ("single", "double"):
            raise ValueError(f"unknown sourcing {sourcing!r}")
        self.g_us = g
        self.m, self.n = g.shape
        self.g_wl = _wire_conductance_us(r_wl_ohm)
        self.g_bl = _wire_conductance_us(r_bl_ohm)
        self.sourcing = sourcing
        self.n_unknowns = 2 * self.m * self.n
        self.device = g.device
        self.iterations = 0
        self.residual_ua = float("nan")
        wl_ends = (0, self.n - 1) if sourcing == "double" else (0,)
        wl = _chain(self.n, self.g_wl, wl_ends, g.device)
        bl = _chain(self.m, self.g_bl, (self.m - 1,), g.device)
        # the chains' diagonals (for the matrix-free product) and their
        # Cholesky factors with the cells on the diagonal: (m, n, n), (n, m, m)
        self._wl_deg = torch.diagonal(wl)
        self._bl_deg = torch.diagonal(bl)[:, None]
        self._wl_chol = torch.linalg.cholesky(wl + torch.diag_embed(g))
        self._bl_chol = torch.linalg.cholesky(bl + torch.diag_embed(g.T))

    # -- the operator, on voltages shaped (k, 2, m, n) ----------------------

    def _currents(self, v: torch.Tensor, x=None) -> torch.Tensor:
        """Net current into every node (µA), each branch's current taken
        from its own voltage difference: ``-A @ v``, plus the drivers'
        injections ``b`` where ``x`` is given (then the KCL residual
        ``b - A @ v``).  Differences first, so a wire's 10^6 µS multiplies
        a small number and the residual keeps the digits that
        ``b - A @ v`` as a sum of large terms would cancel."""
        w, b = v[:, 0], v[:, 1]
        g = self.g_us
        cell = g * (b - w)                  # into the wordline node
        iw = cell.clone()
        dw = self.g_wl * (w[..., 1:] - w[..., :-1])
        iw[..., :-1] += dw
        iw[..., 1:] -= dw
        drive = 0.0 if x is None else x[:, :, None]
        iw[..., :1] += self.g_wl * (drive - w[..., :1])
        if self.sourcing == "double":
            iw[..., -1:] += self.g_wl * (drive - w[..., -1:])
        ib = -cell
        db = self.g_bl * (b[..., 1:, :] - b[..., :-1, :])
        ib[..., :-1, :] += db
        ib[..., 1:, :] -= db
        ib[..., -1, :] -= self.g_bl * b[..., -1, :]
        return torch.stack((iw, ib), dim=1)

    def _precondition(self, r: torch.Tensor) -> torch.Tensor:
        # wordlines: per row i, (n, k) right-hand sides; bitlines per column
        zw = torch.cholesky_solve(r[:, 0].permute(1, 2, 0), self._wl_chol)
        zb = torch.cholesky_solve(r[:, 1].permute(2, 1, 0), self._bl_chol)
        return torch.stack((zw.permute(2, 0, 1), zb.permute(2, 1, 0)), dim=1)

    def _drive(self, x) -> tuple:
        x = torch.as_tensor(x, dtype=torch.float64, device=self.device)
        if x.shape[-1:] != (self.m,) or x.ndim > 2:
            raise ValueError(f"x must have shape ({self.m},) or (k, "
                             f"{self.m}), got {tuple(x.shape)}")
        return x.reshape(-1, self.m), x.ndim == 1

    def _cg(self, r: torch.Tensor, reduce: float) -> tuple:
        """Preconditioned CG for ``A d = r``, every right-hand side its
        own step sizes, until each one's residual has fallen ``reduce``
        times; returns ``(d, iterations)``."""
        k = r.shape[0]

        def dot(a, b):
            return (a * b).reshape(k, -1).sum(dim=1)[:, None, None, None]

        def amax(a):
            return a.abs().reshape(k, -1).amax(dim=1)

        goal = amax(r) * reduce
        d = torch.zeros_like(r)
        z = self._precondition(r)
        p = z.clone()
        rz = dot(r, z)
        for it in range(1, MAX_ITER + 1):
            ap = -self._currents(p)
            pap = dot(p, ap)
            alpha = torch.where(pap > 0, rz / pap, torch.zeros_like(rz))
            d += alpha * p
            r = r - alpha * ap
            if bool((amax(r) <= goal).all()):
                return d, it
            z = self._precondition(r)
            rz_new = dot(r, z)
            beta = torch.where(rz > 0, rz_new / rz, torch.zeros_like(rz))
            p = z + beta * p
            rz = rz_new
        raise RuntimeError(f"nodal CG: no convergence in {MAX_ITER} "
                           f"iterations ({self.m}x{self.n})")

    def tolerance(self, x) -> float:
        """The KCL imbalance (µA) a solve under drive ``x`` must reach:
        ``RTOL`` of the largest wire current, ``g_wire * max(1, max|x|)``."""
        x = torch.as_tensor(x, dtype=torch.float64)
        return RTOL * max(self.g_wl, self.g_bl) * max(
            1.0, float(x.abs().max()))

    def _solve(self, x: torch.Tensor) -> torch.Tensor:
        """Voltages (k, 2, m, n): CG rounds on the exact residual
        (iterative refinement) until the KCL imbalance is within
        :meth:`tolerance` or stops falling."""
        v = x.new_zeros((x.shape[0], 2, self.m, self.n))
        tol = self.tolerance(x)
        r = self._currents(v, x)
        res, its = float(r.abs().max()), 0
        for _ in range(MAX_ROUNDS):
            d, n_it = self._cg(r, CG_REDUCE)
            its += n_it
            v_new = v + d
            r_new = self._currents(v_new, x)
            res_new = float(r_new.abs().max())
            if res_new >= res:
                break
            v, r, res = v_new, r_new, res_new
        if res > tol:
            raise RuntimeError(
                f"nodal CG: KCL residual {res:.3e} µA above its tolerance "
                f"{tol:.3e} ({self.m}x{self.n}, {its} iterations)")
        self.iterations, self.residual_ua = its, res
        return v

    # -- the reference's interface -------------------------------------------

    def node_voltages(self, x) -> torch.Tensor:
        """All node voltages under drive ``x`` (volts), in the reference's
        order ``[W.ravel(), B.ravel()]``: (2mn,) or (k, 2mn)."""
        xs, single = self._drive(x)
        v = self._solve(xs).reshape(xs.shape[0], -1)
        return v[0] if single else v

    def kcl_residual(self, v, x) -> float:
        """Max |KCL current imbalance| of a solution, in µA."""
        xs, _ = self._drive(x)
        v = torch.as_tensor(v, dtype=torch.float64, device=self.device)
        v = v.reshape(xs.shape[0], 2, self.m, self.n)
        return float(self._currents(v, xs).abs().max())

    def output_currents(self, x, check_residual: bool = False
                        ) -> torch.Tensor:
        """Per-column TIA currents in µA for drive voltages ``x``."""
        xs, single = self._drive(x)
        v = self._solve(xs)
        if check_residual:
            scale = max(1.0, float(self.g_us.abs().max())
                        * float(xs.abs().max()))
            if self.residual_ua > 1e-6 * scale:
                raise AssertionError(
                    f"KCL residual {self.residual_ua:.3e} µA exceeds "
                    f"tolerance")
        y = self.g_bl * v[:, 1, -1, :]
        return y[0] if single else y


def solve_nodal(g_us, x, r_wl_ohm: float, r_bl_ohm: float,
                sourcing: str = "single", check_residual: bool = False, *,
                device="cuda") -> torch.Tensor:
    """Exact column currents (µA) of one parasitic crossbar under drive x."""
    sys_ = NodalSystem(g_us, r_wl_ohm, r_bl_ohm, sourcing, device=device)
    return sys_.output_currents(x, check_residual)


def exact_effective_conductances(g_us, r_wl_ohm: float, r_bl_ohm: float,
                                 sourcing: str = "single", *,
                                 device="cuda") -> torch.Tensor:
    """The exact effective-conductance matrix G_eff (µS): row ``i`` is the
    column currents of a unit drive on wordline ``i`` alone (the other
    drivers at 0 V, still loading the network).  The unit drives are
    solved in batches of rows."""
    sys_ = NodalSystem(g_us, r_wl_ohm, r_bl_ohm, sourcing, device=device)
    eye = torch.eye(sys_.m, dtype=torch.float64, device=sys_.device)
    return torch.cat([sys_.output_currents(eye[i:i + _ROWS_PER_SOLVE])
                      for i in range(0, sys_.m, _ROWS_PER_SOLVE)])


def exact_mac(g_us, x, r_wl_ohm: float, r_bl_ohm: float,
              sourcing: str = "single", *, device="cuda") -> torch.Tensor:
    """Exact single-polarity MAC y_j (µA) including all parasitics."""
    return solve_nodal(g_us, x, r_wl_ohm, r_bl_ohm, sourcing,
                       check_residual=True, device=device)


def _pairs(w, device):
    """The differential mapping in float64: one weight -> (G+, G-) µS."""
    w = torch.as_tensor(w, dtype=torch.float64, device=device).clamp(
        -W_CLIP, W_CLIP)
    return GAMMA_US * w.clamp(min=0.0), GAMMA_US * (-w).clamp(min=0.0)


def exact_mac_weights(w, x, r_wl_ohm: float, r_bl_ohm: float,
                      sourcing: str = "single", *, device="cuda",
                      systems: Optional[List[NodalSystem]] = None
                      ) -> torch.Tensor:
    """Exact differential-pair MAC in weight units (the oracle of
    :func:`repro_torch.core.crossbar.ir_effective_weights`): each polarity
    is its own physical array, read with the same drive, recombined
    digitally.  Where ``systems`` is a list, the two solved systems are
    appended to it (positive array first) for their ``iterations`` and
    ``residual_ua``."""
    ys = []
    for g in _pairs(w, device):
        sys_ = NodalSystem(g, r_wl_ohm, r_bl_ohm, sourcing, device=device)
        ys.append(sys_.output_currents(x))
        if systems is not None:
            systems.append(sys_)
    return (ys[0] - ys[1]) / GAMMA_US


def exact_effective_weights(w, r_wl_ohm: float, r_bl_ohm: float,
                            sourcing: str = "single", *,
                            device="cuda") -> torch.Tensor:
    """Exact effective weight matrix of the differential deployment."""
    g_pos, g_neg = _pairs(w, device)
    return (exact_effective_conductances(g_pos, r_wl_ohm, r_bl_ohm,
                                         sourcing, device=device)
            - exact_effective_conductances(g_neg, r_wl_ohm, r_bl_ohm,
                                           sourcing, device=device)
            ) / GAMMA_US


def exact_ramp_attenuation(g_us, r_wl_ohm: float, r_bl_ohm: float,
                           wl_segments: float = 0.0, *,
                           device="cuda") -> torch.Tensor:
    """Exact sequential-read attenuation of a ramp column (one device on at
    a time): a voltage divider along the device's series path, the
    oracle-side twin of :func:`repro_torch.core.crossbar.
    ramp_series_attenuation`."""
    g = torch.as_tensor(g_us, dtype=torch.float64, device=device) * 1e-6
    k = torch.arange(g.shape[-1], dtype=torch.float64, device=g.device)
    r_series = r_bl_ohm * (g.shape[-1] - k) + r_wl_ohm * wl_segments
    return 1.0 / (1.0 + g * r_series)
