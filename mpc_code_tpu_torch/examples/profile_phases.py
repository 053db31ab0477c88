"""Per-phase profile of the structured IPM's pass at the bench operating point.

Port of ``tools/profile_phases.py``.  A pass of the structured solver
splits into (1) the stage-derivative sweep (the dynamics sweep, kernel 1,
plus the cost's Hessian and gradient and the output rows' Jacobian by
``torch.func``), (2) the Riccati KKT solve (kernel 2), (3) the residual
assembly (one rollout of the generic map and the rows) and (4) a merit
evaluation (the cost plus the residuals' l1 norm, one line-search
trial).  Each phase runs on the bench's batch (CSTR NMPC, f32 on the
card, Gauss-Newton) at a representative iterate, K times back to back
between two CUDA events, and its time is the average; the full solve is
timed the same way for reference.  JAX's K-vs-1 difference quotient
exists for a remote TPU's dispatch floor and has no counterpart here.

    python -m mpc_code_tpu_torch.examples.profile_phases [--batch 2048]
        [--n 50] [--reps 5] [--k 16] [--mx 10] [--max-iter 40] [--cpu]
        [--trace DIR]

``--cpu`` runs on the CPU in f64 with the host clock; ``--trace DIR``
writes a ``torch.profiler`` trace of one full solve (chrome format).
It prints one JSON line per phase, as the JAX tool does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--n", type=int, default=50)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--mx", type=int, default=10, help="RK4 sub-steps (the bench's 10)")
    ap.add_argument("--max-iter", type=int, default=40, help="the solver's cap")
    ap.add_argument("--k", type=int, default=16, help="back-to-back runs per timing")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--trace", default=None,
                    help="write a torch.profiler trace of one solve to DIR")
    args = ap.parse_args(argv)

    from torch.func import vmap

    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.device import pin_fp32_precision, resolve_device
    from mpc_code_tpu_torch.examples.bench_workload import (
        U_SS, XHI, XLO, bench_params, make_problem,
    )
    from mpc_code_tpu_torch.solver.riccati import (
        batch_params, make_stage_derivs, make_structured_solver,
    )
    from mpc_code_tpu_torch.solver.riccati_kernel import riccati_kkt

    dev = resolve_device("cpu" if args.cpu else None)
    if dev.type == "cuda":
        pin_fp32_precision()
    dtype = torch.float64 if dev.type == "cpu" else torch.float32
    kw = dict(dtype=dtype, device=dev)
    N, B = args.n, args.batch
    cfg, model, socp, _ = make_problem(dev, Nh=N, Mx=args.mx)
    opts = SolverOptions(max_iter=args.max_iter, tol=1e-3, constr_viol_tol=1e-3,
                         hessian="gauss_newton")
    nxa, nu, ni = socp.nxa, socp.nu, socp.ni
    nz = nxa + nu

    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(rng.uniform(XLO, XHI, size=(B, 3)).astype(np.float32), **kw)
    p = batch_params(bench_params(cfg, x0s, N), B, dtype, dev)
    p["_sf"] = torch.ones(B, **kw)
    pk = socp.params.stage(p, N)
    pN = socp.params.terminal(p)
    # a representative iterate in scaled units: x0 held over the horizon,
    # the steady input
    sxa, su = (torch.as_tensor(v, **kw) for v in (socp.sxa, socp.su))
    X = (x0s / sxa)[:, None].expand(B, N + 1, nxa).contiguous()
    U = (torch.as_tensor(U_SS, **kw) / su).expand(B, N, nu).contiguous()
    Zs = torch.cat([X[:, :N], U], -1).reshape(B * N, nz)
    v_rest = vmap(make_stage_derivs(socp, "gauss_newton", skip_dyn=True))
    v_dyn = vmap(lambda z, q: socp.dyn(z[:nxa], z[nxa:], q))
    v_ineq = vmap(lambda z, q: socp.ineq(z[:nxa], z[nxa:], q))
    v_cost = vmap(lambda z, q: socp.cost(z[:nxa], z[nxa:], q))

    def sweep():
        return v_rest(Zs, pk) + socp.stage_dyn_jac(X[:, :N], U, p)

    derivs = sweep()
    H, gc = derivs[0].reshape(B, N, nz, nz), derivs[1].reshape(B, N, nz)
    A, Bm = derivs[-2], derivs[-1]
    rd = torch.zeros((B, N, nxa), **kw)
    PN = torch.eye(nxa, **kw).expand(B, nxa, nxa).contiguous()
    pN_v = torch.zeros((B, nxa), **kw)
    delta = torch.zeros(B, **kw)

    def kkt():
        return riccati_kkt(H, gc, A, Bm, rd, PN, pN_v, delta, nxa=nxa, nu=nu)

    def residuals():
        out = [v_dyn(Zs, pk).reshape(B, N, nxa) - X[:, 1:]]
        if ni:
            out.append(v_ineq(Zs, pk).reshape(B, N, ni))
        return out

    def merit():
        cost = v_cost(Zs, pk).reshape(B, N).sum(1) + vmap(socp.cost_N)(X[:, N], pN)
        return cost + sum(r.abs().flatten(1).sum(1) for r in residuals())

    solve = make_structured_solver(socp, opts)
    X0 = x0s[:, None].expand(B, N + 1, 3).contiguous()
    U0 = torch.as_tensor(U_SS, **kw).expand(B, N, nu).contiguous()
    p_solve = bench_params(cfg, x0s, N)

    def full():
        return solve(p_solve, X0, U0)

    def timeit(fn, k):
        """(seconds per call over k back-to-back calls, the best of reps;
        the warm-up call's result)."""
        first = fn()
        best = np.inf
        for _ in range(args.reps):
            if dev.type == "cuda":
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                torch.cuda.synchronize(dev)
                start.record()
                for _ in range(k):
                    fn()
                end.record()
                torch.cuda.synchronize(dev)
                t = start.elapsed_time(end) / 1e3 / k
            else:
                t0 = time.perf_counter()
                for _ in range(k):
                    fn()
                t = (time.perf_counter() - t0) / k
            best = min(best, t)
        return best, first

    full_t, res = timeit(full, 1)
    med_iters = float(np.median(res.iters.cpu().numpy()))
    rows = [(name, timeit(fn, args.k)[0]) for name, fn in (
        ("deriv_sweep(solver path)", sweep), ("riccati_kkt", kkt),
        ("residuals", residuals), ("merit_eval", merit))]
    rows.append(("full_solve", full_t))
    per_iter = full_t / max(med_iters, 1.0)
    print(f"# B={B} N={N} platform={dev.type} med_iters={med_iters:.0f} "
          f"per_iter={per_iter * 1e3:.2f}ms", file=sys.stderr, flush=True)
    out = []
    for name, t in rows:
        out.append({"phase": name, "ms_per_batch": round(t * 1e3, 3),
                    "ms_per_iter_budget": round(per_iter * 1e3, 3),
                    "fraction_of_iter": (round(t / per_iter, 3) if name != "full_solve"
                                         else None)})
        print(json.dumps(out[-1]), flush=True)

    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if dev.type == "cuda" else [ProfilerActivity.CPU]
        with profile(activities=acts) as prof:
            full()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, "solve_trace.json")
        prof.export_chrome_trace(path)
        print(f"# torch.profiler trace written to {path}", file=sys.stderr, flush=True)
    return out


if __name__ == "__main__":
    main()
