"""One-shot timed autotune of the Gauss-Newton stage derivatives' route.

Port of ``mpc_code_tpu/ops/sweep_autotune.py``.  JAX's autotune picks, on
the actual model at the hinted batch, the fastest of its implementations
of the dynamics sweep.  In the port the real choice is between two
routes to the structured solver's Gauss-Newton stage derivatives of a
shooting OCP with a dynamics sweep that the fused stage sweep lowers
(``StageLowering``: the continuous or the discrete map, with or without
the u_prev augmentation, the shared slacks and the user rows):

- ``"split"``: the dynamics sweep (kernel 1, ``ops/sweep_cuda.py``, or
  for a discrete map kernel 3, ``ops/sweep_map_cuda.py``) plus the stage
  cost's Hessian and gradient and the inequality rows' Jacobian by
  ``torch.func`` (the default route);
- ``"fused"``: the fused stage sweep's Gauss-Newton build (kernel 5,
  ``solver/sweep_kernel.py::make_stage_sweep(s, "gauss_newton")``): every
  output in one launch.

With ``MPC_TPU_SWEEP_AUTOTUNE=1``, ``build_structured_ocp(...,
batch_hint=B)`` times both at B lanes (one warm call each, then the best
of two), records the faster as the OCP's ``sweep_impl`` (the solver's
``impl=``), and caches the decision in ``sweep_autotune_torch.json`` in
``MPC_TPU_AOT_CACHE``'s directory, keyed by a content hash of the model
function, the stage cost, Mx, the guard's bounds, the shapes, the device,
the torch version and the port's source, so a new toolchain or card
probes again.  Where there is no split dynamics sweep to weigh the fused
sweep against (a ``LinearModel``, collocation and ContForm with slacks,
which take the fused sweep under either Hessian; ContForm, whose
Gauss-Newton route is kernel 4's joint sweep) or no lowering, it returns
``"split"`` without a probe.  There is no
fallback: on the card both candidates are kernels, and one that fails to
build or launch raises.  ``PROBES``
counts the probes that timed the candidates (a cached answer adds none),
and ``LAST_TIMES`` holds the last probe's seconds by candidate.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

PROBES = 0
LAST_TIMES: dict = {}


def _cache_path() -> str:
    from mpc_code_tpu_torch.utils.aot import default_cache_dir

    d = default_cache_dir()
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, "sweep_autotune_torch.json")


def fused_applies(s) -> bool:
    """Whether the fused stage sweep can take the OCP's Gauss-Newton
    derivatives in place of the split route: an OCP with both."""
    return s.lowering is not None and s.stage_dyn_jac is not None


def candidates(s):
    """``{name: fn(X, U, p, pk, lam, nus)}``: the Gauss-Newton stage
    derivatives of the OCP ``s`` by each route at a batch of iterates, in
    scaled units, with the solver's batched parameters ``p`` and their
    per-point form ``pk`` (both with ``_sf``)."""
    from torch.func import vmap

    from mpc_code_tpu_torch.solver.riccati import make_stage_derivs
    from mpc_code_tpu_torch.solver.sweep_kernel import make_stage_sweep

    v_stage = vmap(make_stage_derivs(s, "gauss_newton", skip_dyn=True))
    nz = s.nxa + s.nu
    fused = make_stage_sweep(s, "gauss_newton")

    def split(X, U, p, pk, lam, nus):
        Zs = torch.cat([X, U], -1).reshape(-1, nz)
        return v_stage(Zs, pk) + s.stage_dyn_jac(X, U, p)

    def fused_route(X, U, p, pk, lam, nus):
        mu_h = lam.new_zeros(lam.shape[:2] + (s.n_eq,))
        return fused(*fused.inputs(X, U, p, lam, nus, mu_h))

    return {"split": split, "fused": fused_route}


def probe_inputs(cfg, s, batch, device, dtype, seed=0):
    """A batch of representative iterates: every state and input in
    scaled units at the middle of its box (0 where a side is open) plus
    noise of 0.1, the parameters at zero disturbance and schedules."""
    from mpc_code_tpu_torch.solver.riccati import batch_params

    rng = np.random.default_rng(seed)
    N, nxa, nu = s.N, s.nxa, s.nu

    def mid(lo, hi):
        lo, hi = np.asarray(lo, float), np.asarray(hi, float)
        ok = (lo > -1e18) & (hi < 1e18)
        return 0.5 * (np.where(ok, lo, 0.0) + np.where(ok, hi, 0.0))

    kw = dict(dtype=dtype, device=device)
    X = torch.as_tensor(mid(s.lbx, s.ubx) + 0.1 * rng.normal(size=(batch, N, nxa)), **kw)
    U = torch.as_tensor(mid(s.lbu, s.ubu) + 0.1 * rng.normal(size=(batch, N, nu)), **kw)
    nx, nuc = s.lowering.nx, s.nu_ctrl
    p = dict(x0=np.zeros(nx), xs=np.zeros(nx), us=np.zeros(nuc), d=np.zeros(cfg.nd),
             um1=np.zeros(nuc), t=0.0, lam=np.zeros((cfg.ny, nuc)),
             px=np.zeros((N, cfg.npx)), py=np.zeros((N, cfg.npy)))
    p = batch_params(p, batch, dtype, device, s.params.ndim)
    p["_sf"] = torch.ones(batch, **kw)
    pk = s.params.stage(p, N)
    lam = torch.zeros((batch, N, nxa), **kw)
    nus = torch.zeros((batch, N, s.ni), **kw)
    return X, U, p, pk, lam, nus


def autotune_sweep_impl(cfg, s, batch: int, device=None, verbose: bool = False) -> str:
    """Return the faster route ('split' | 'fused') for the OCP ``s`` of
    ``cfg`` at ``batch`` lanes on ``device`` (default the OCP's), timing
    each once and caching the answer; 'split' without a probe where
    'fused' does not apply."""
    global PROBES
    if not fused_applies(s):
        return "split"
    from mpc_code_tpu_torch.utils.aot import _source_tree_hash, content_hash

    dev = torch.device(device) if device is not None else s.device
    dtype = torch.float32 if dev.type == "cuda" else torch.float64
    low = s.lowering
    dev_tag = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type)
    key = content_hash(low.kind, low.ode, low.fmap, low.cost, low.ineq, low.eq, low.Mx,
                       low.clip_lo, low.clip_hi, low.nup, low.ns,
                       int(batch), s.N, s.nxa, s.nu, s.ni, cfg.npx, cfg.nd, cfg.npy,
                       dev_tag, str(dtype), torch.__version__, _source_tree_hash())
    path = _cache_path()
    try:
        with open(path) as fh:
            cache = json.load(fh)
    except (OSError, ValueError):
        cache = {}
    if key in cache:
        return cache[key]

    PROBES += 1
    args = probe_inputs(cfg, s, int(batch), dev, dtype)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    times = {}
    for name, fn in candidates(s).items():
        fn(*args)                         # builds the kernel, first use
        sync()
        best = np.inf
        for r in range(2):
            X = args[0] + 1e-6 * (r + 1)
            sync()
            t0 = time.perf_counter()
            fn(X, *args[1:])
            sync()
            best = min(best, time.perf_counter() - t0)
        times[name] = best
    winner = min(times, key=times.get)
    LAST_TIMES.clear()
    LAST_TIMES.update(times)
    if verbose:
        print("# autotune sweep impl: "
              + ", ".join(f"{k}={v * 1e3:.3f}ms" for k, v in times.items())
              + f" -> {winner}", flush=True)
    cache[key] = winner
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(cache, fh)
    os.replace(tmp, path)
    return winner
