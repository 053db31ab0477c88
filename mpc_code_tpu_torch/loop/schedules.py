"""Per-step schedules for the closed loop (port of ``mpc_code_tpu/loop/schedules.py``).

Time-varying parameters, setpoints and white-noise draws.  The reference
evaluates its schedule hooks at the top of every sampling instant
(MPC_code.py:489-515 parameters, 677-680 setpoints) and draws white noise
inline (MPC_code.py:537-541, 823-827).  The batched loop precomputes the
whole simulation's schedule once with :func:`make_step_inputs` into a
:class:`StepInput` with a leading ``(Nsim,)`` axis and feeds one row per
step (``loop/batched.py::run_traced``).

The schedules are plain numpy, as in the JAX package, and the draw order
is the same (per step: output noise then process noise, drawn only when
the corresponding covariance is configured) from the same
``np.random.default_rng(cfg.noise_seed)`` stream, so the port's inputs are
bit-identical to JAX's.  Only the tensors are torch's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from mpc_code_tpu_torch.config import MPCConfig


class StepInput(NamedTuple):
    """Per-instant exogenous data of one closed-loop step (static shapes;
    stacked over a leading ``(Nsim,)`` axis by ``make_step_inputs``).  All
    lanes of a batch share one StepInput."""

    px_h: object   # (N, npx)  model state params over the horizon
    py_h: object   # (N, npy)  model output params over the horizon
    pxp: object    # (npxp,)   plant state params (non-measurable)
    pyp: object    # (npyp,)   plant output params (non-measurable)
    pxmp: object   # (npxp,)   measurable plant state params
    pymp: object   # (npyp,)   measurable plant output params
    ysp: object    # (ny,)     output setpoint
    usp: object    # (nu,)     input setpoint
    xsp: object    # (nx,)     state setpoint
    v_wn: object   # (ny,)     standard-normal output-noise draw
    w_wn: object   # (nxp,)    standard-normal process-noise draw


def _call(fn, t, n):
    if fn is None:
        return np.zeros(n)
    return np.asarray(fn(t), dtype=float).reshape(n)


def eval_step_params(cfg: MPCConfig, t_k: float):
    """The reference's per-instant parameter block (MPC_code.py:489-515):
    horizon schedules sampled at ``t_k + i`` for i in range(N), measurable
    plant params defaulting to the model schedule when absent."""
    N = cfg.N
    npx, npy, npxp, npyp = cfg.npx, cfg.npy, cfg.npxp, cfg.npyp
    if cfg.def_px is not None:
        px_h = np.stack([_call(cfg.def_px, t_k + i, npx) for i in range(N)])
    else:
        px_h = np.zeros((N, npx))
    if cfg.def_py is not None:
        py_h = np.stack([_call(cfg.def_py, t_k + i, npy) for i in range(N)])
    else:
        py_h = np.zeros((N, npy))
    if cfg.def_px is not None and cfg.def_pxmp is not None:
        pxmp = _call(cfg.def_pxmp, t_k, npxp)
    elif cfg.def_px is not None:
        pxmp = px_h[0]
    else:
        pxmp = np.zeros(npxp)
    if cfg.def_py is not None and cfg.def_pymp is not None:
        pymp = _call(cfg.def_pymp, t_k, npyp)
    elif cfg.def_py is not None:
        pymp = py_h[0]
    else:
        pymp = np.zeros(npyp)
    pxp = _call(cfg.def_pxp, t_k, npxp)
    pyp = _call(cfg.def_pyp, t_k, npyp)
    return px_h, py_h, pxp, pyp, pxmp, pymp


def eval_setpoints(cfg: MPCConfig, t_k: float):
    """Setpoint schedule (MPC_code.py:677-680): ``defSP(t) -> (ysp, usp,
    xsp)``; zeros when absent."""
    if cfg.defSP is not None:
        ysp, usp, xsp = (np.asarray(v, float).reshape(-1) for v in cfg.defSP(t_k))
        return ysp, usp, xsp
    return np.zeros(cfg.ny), np.zeros(cfg.nu), np.zeros(cfg.nx)


def default_step_input(cfg: MPCConfig, ysp=None, usp=None, xsp=None,
                       dtype=torch.float64, device="cpu") -> StepInput:
    """A single fixed StepInput (no schedules, no noise): the batched
    step's default when called without explicit inputs."""
    kw = dict(dtype=dtype, device=device)

    def sp(v, n):
        return (torch.zeros(n, **kw) if v is None
                else torch.as_tensor(np.asarray(v, float).reshape(-1), **kw))

    return StepInput(
        px_h=torch.zeros((cfg.N, cfg.npx), **kw),
        py_h=torch.zeros((cfg.N, cfg.npy), **kw),
        pxp=torch.zeros(cfg.npxp, **kw), pyp=torch.zeros(cfg.npyp, **kw),
        pxmp=torch.zeros(cfg.npxp, **kw), pymp=torch.zeros(cfg.npyp, **kw),
        ysp=sp(ysp, cfg.ny), usp=sp(usp, cfg.nu), xsp=sp(xsp, cfg.nx),
        v_wn=torch.zeros(cfg.ny, **kw), w_wn=torch.zeros(cfg.nxp, **kw),
    )


def make_step_inputs(cfg: MPCConfig, Nsim: Optional[int] = None,
                     t0: float = 0.0, k0: int = 0,
                     rng: Optional[np.random.Generator] = None,
                     noise: bool = True, dtype=None, device="cpu") -> StepInput:
    """Precompute the full simulation's StepInput stack, leading ``(Nsim,)``.

    ``t0``/``k0``: start time / start index (for continuing a run, pass
    ``k0`` = the steps already taken so the noise stream stays aligned with
    a fresh full-length run).  ``noise=False`` zeroes the noise fields
    without consuming the stream.  The stack is numpy (f64) unless
    ``dtype`` is given, and then torch tensors on ``device``.
    """
    Nsim = cfg.Nsim if Nsim is None else Nsim
    if rng is None:
        rng = np.random.default_rng(cfg.noise_seed)
        # burn the pre-k0 draws so a continuation sees the same stream a
        # full-length run would at step k0
        for _ in range(k0):
            if cfg.R_wn is not None:
                rng.standard_normal(cfg.ny)
            if cfg.Q_wn is not None and cfg.G_wn is not None:
                rng.standard_normal(cfg.nxp)

    rows = []
    for k in range(Nsim):
        t_k = t0 + k * cfg.h
        px_h, py_h, pxp, pyp, pxmp, pymp = eval_step_params(cfg, t_k)
        ysp, usp, xsp = eval_setpoints(cfg, t_k)
        v = (rng.standard_normal(cfg.ny) if cfg.R_wn is not None
             else np.zeros(cfg.ny))
        w = (rng.standard_normal(cfg.nxp)
             if cfg.Q_wn is not None and cfg.G_wn is not None
             else np.zeros(cfg.nxp))
        if not noise:
            v = np.zeros(cfg.ny)
            w = np.zeros(cfg.nxp)
        rows.append(StepInput(px_h, py_h, pxp, pyp, pxmp, pymp,
                              ysp, usp, xsp, v, w))
    stacked = StepInput(*(np.stack([getattr(r, f) for r in rows])
                          for f in StepInput._fields))
    if dtype is not None:
        stacked = StepInput(*(torch.as_tensor(a, dtype=dtype, device=device)
                              for a in stacked))
    return stacked
