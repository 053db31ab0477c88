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


class _LUSolve(torch.autograd.Function):
    """X = A^-1 B by ``linalg.solve_ex`` (a singular lane NaN), with its
    derivatives written out in terms of itself: backward gB = A^-T G,
    gA = -gB X'; forward dX = A^-1 (dB - dA X).  ``linalg.solve_ex``'s own
    forward-mode rule comes out wrong under ``vmap(jacfwd(...))`` (F13),
    and ``linalg.lu`` has no batching rule (``vmap`` loops over lanes)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(A, B):
        X, info = torch.linalg.solve_ex(A, B)
        return _nan_where(info > 0, X)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)
        ctx.save_for_forward(inputs[0], output)

    @staticmethod
    def backward(ctx, G):
        A, X = ctx.saved_tensors
        gB = _LUSolve.apply(A.transpose(-1, -2), G)
        return -gB @ X.transpose(-1, -2), gB

    @staticmethod
    def jvp(ctx, dA, dB):
        A, X = ctx.saved_tensors
        return _LUSolve.apply(A, dB - dA @ X)


def solve_lu_ad(A, b):
    """The solve of a call site whose result AD traverses (the collocation
    Newton step, ``solver/riccati.py``): ``torch.func``'s ``jacrev``,
    ``jacfwd`` and ``vmap`` batch and differentiate it without a loop over
    lanes, reverse over reverse and forward over reverse included; b (...,
    n) or (..., n, k).  A singular lane comes back as NaN, as ``solve_lu``
    gives."""
    vec = b.dim() == A.dim() - 1
    x = _LUSolve.apply(A, b.unsqueeze(-1) if vec else b)
    return x.squeeze(-1) if vec else x


def inv(A):
    """Inverse of (..., n, n) by pivoted LU; a singular lane comes back as
    NaN, where ``torch.linalg.inv`` raises for the whole batch and JAX's
    unrolled elimination gives non-finite values on that lane only."""
    Ainv, info = torch.linalg.inv_ex(A)
    return _nan_where(info > 0, Ainv)
