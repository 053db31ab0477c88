"""Small dense linear-algebra helpers (port of ``mpc_code_tpu/ops/linalg.py``)."""

from __future__ import annotations

import torch


def sqrtm_psd(M):
    """Symmetric PSD matrix square root via eigendecomposition."""
    w, V = torch.linalg.eigh(0.5 * (M + M.transpose(-1, -2)))
    w = torch.clamp(w, min=0.0)
    return (V * torch.sqrt(w).unsqueeze(-2)) @ V.transpose(-1, -2)


def solve_sym(M, b, reg: float = 0.0):
    """Solve ``M x = b`` for symmetric M with optional Tikhonov regularization."""
    if reg:
        M = M + reg * torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return torch.linalg.solve(M, b)
