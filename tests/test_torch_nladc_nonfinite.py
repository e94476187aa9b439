"""NaN and +-inf at the comparator, on both backends of both packages.

The two ways the repo counts thresholds below x part on NaN:

* ``searchsorted(side="left")`` -- JAX's ``ref`` backend
  (``repro/core/nladc.py``) and the port's (``repro_torch.core.nladc``,
  ``torch.searchsorted(right=False)``) -- gives NaN the code P;
* the explicit count ``sum_k [x > V_k]`` -- the Pallas kernel
  (``repro.kernels.nladc_kernel.nladc_pallas``, run in interpret mode as
  ``tests/test_backend_parity.py`` runs the ``pallas`` backend), the port's
  ``kernels/ref.py::thermometer_count``, the NL-ADC kernel's plain version
  and its CUDA kernel -- gives NaN 0, since every compare with NaN is false.

Each port backend holds to its JAX twin.  +inf counts every threshold and
-inf none on all of them.  Thresholds ``[-1, 0, 1]``, one ``(P,)`` ramp and
the same ramp as a per-column ``(N, P)`` bank; x ``[nan, inf, -inf, 0.5]``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as JBK
from repro.core import nladc as JN
from repro.kernels.nladc_kernel import nladc_pallas
from repro_torch.core import backend as TBK
from repro_torch.core import nladc as TN
from repro_torch.kernels import nladc as TNK
from repro_torch.kernels.ref import thermometer_count

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

THR = np.array([-1.0, 0.0, 1.0], np.float32)
X = np.array([[np.nan, np.inf, -np.inf, 0.5]], np.float32)
SEARCHSORTED_CODES = [3, 3, 0, 2]     # JAX and port ``ref``
COUNT_CODES = [0, 3, 0, 2]            # Pallas, the port's count and kernel


def _count_ramp(module):
    """A 2-bit ramp (P = 3) with the thresholds above and ``y(n) = n``."""
    ramp = module.build_ramp("tanh", 2).with_thresholds(THR.astype(np.float64))
    return dataclasses.replace(ramp, y_table=np.arange(len(THR) + 1.0),
                               split_index=-1, monotonic_split=False)


def _codes(a) -> list:
    return np.asarray(a, np.float32).reshape(-1).astype(np.int64).tolist()


@pytest.mark.parametrize("banked", [False, True])
def test_ref_backends_count_nan_as_searchsorted(banked):
    n = X.shape[-1]
    if banked:
        thr_j = JN.BankedThresholds(jnp.asarray(THR[None]),
                                    JN.bank_map_for(n, n))
        thr_t = TN.BankedThresholds(torch.from_numpy(THR[None].copy()),
                                    TN.bank_map_for(n, n))
        port = TN.nladc_banked_codes(torch.from_numpy(X), thr_t)
    else:
        thr_j = jnp.asarray(THR)
        thr_t = torch.from_numpy(THR.copy())
        port = TN.nladc_codes(torch.from_numpy(X), thr_t)
    jax_ref = JBK.get_backend("ref").nladc(
        jnp.asarray(X), JN.NLADC(_count_ramp(JN)), thr_j)
    port_ref = TBK.get_backend("ref").nladc(
        torch.from_numpy(X), TN.NLADC(_count_ramp(TN)), thr_t)
    assert _codes(jax_ref) == SEARCHSORTED_CODES
    assert _codes(port) == SEARCHSORTED_CODES
    assert _codes(port_ref) == SEARCHSORTED_CODES


@pytest.mark.parametrize("banked", [False, True])
def test_counts_give_nan_code_zero_as_the_pallas_kernel(banked):
    n = X.shape[-1]
    thr = np.broadcast_to(THR, (n, len(THR))).copy() if banked else THR
    pallas = nladc_pallas(jnp.asarray(X), _count_ramp(JN),
                          thresholds=jnp.asarray(thr), block=X.shape,
                          interpret=True)
    thr_t = torch.from_numpy(thr)
    x_t = torch.from_numpy(X)
    count = torch.arange(len(THR) + 1, dtype=torch.float32)
    n0 = TNK.nladc.launches
    plain = TNK.nladc_plain(x_t, thr_t, count)
    wrapped = TNK.nladc(x_t, thr_t, count)
    assert TNK.nladc.launches == n0          # the CPU takes the plain version
    assert _codes(pallas) == COUNT_CODES
    assert _codes(thermometer_count(x_t, thr_t)) == COUNT_CODES
    assert _codes(plain) == COUNT_CODES
    assert torch.equal(plain, wrapped)
