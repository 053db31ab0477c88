"""Batched small-matrix linear algebra with NaN for each failing lane.

Port of ``mpc_code_tpu/ops/smalllin.py``.  The JAX callers rely on
``jnp.linalg.cholesky`` returning NaN for an indefinite lane only
(``riccati_kernel.py`` computes ``ok &= isfinite(L)``), whereas
``torch.linalg.cholesky`` raises for the whole batch.  Here every
factorization runs through the ``*_ex`` variants and a lane whose ``info``
is non-zero comes back as NaN, so one bad lane never stops the batch
(ROADMAP Queue 3, F2).  The ``_ex`` calls do not synchronise the card.
"""

from __future__ import annotations

import torch


def _nan_where(bad, M):
    return torch.where(bad.reshape(bad.shape + (1,) * (M.dim() - bad.dim())),
                       torch.full_like(M, float("nan")), M)


def chol(A):
    """Lower Cholesky factor of (..., n, n); the lower triangle of a lane
    that is not positive definite is NaN, as ``jnp.linalg.cholesky`` gives."""
    L, info = torch.linalg.cholesky_ex(A)
    n = A.shape[-1]
    lower = torch.ones((n, n), dtype=torch.bool, device=A.device).tril()
    bad = (info > 0).reshape(info.shape + (1, 1)) & lower
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def cho_solve(L, b):
    """Solve ``A x = b`` from the lower factor; b (..., n) or (..., n, k)."""
    vec = b.dim() == L.dim() - 1
    out = torch.cholesky_solve(b.unsqueeze(-1) if vec else b, L)
    return out.squeeze(-1) if vec else out


def solve_lu(A, b):
    """General solve by pivoted LU; a singular lane comes back as NaN."""
    vec = b.dim() == A.dim() - 1
    x, info = torch.linalg.solve_ex(A, b.unsqueeze(-1) if vec else b)
    x = _nan_where(info > 0, x)
    return x.squeeze(-1) if vec else x



def inv(A):
    """Inverse of (..., n, n) by pivoted LU; a singular lane comes back as
    NaN, where ``torch.linalg.inv`` raises for the whole batch and JAX's
    unrolled elimination gives non-finite values on that lane only."""
    Ainv, info = torch.linalg.inv_ex(A)
    return _nan_where(info > 0, Ainv)
