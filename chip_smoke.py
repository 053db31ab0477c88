#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``mpc_code_tpu_torch``).

Run from the repository root, with no arguments, on a machine with one
NVIDIA H100 and the CUDA toolkit:

    python3 chip_smoke.py

It never imports JAX or the JAX package.  Phases:

1. the card's name and power limit (nvidia-smi), then builds both CUDA
   kernels from ``mpc_code_tpu_torch/csrc`` in parallel;
2. kernel phase: each kernel against its plain PyTorch version on the card
   at the main path's shapes, in f64 and f32, with the normalised error
   ``|a-b|/(1+|b|)`` and the kernel and plain times (CUDA events);
3. slice phase: the bench workload through the port's entry points —
   batched cold solves of the CSTR NMPC OCP, B=16384, N=50, Mx=10, seed-0
   draws, pass-1 cap 12, one combined steady/coolhold rescue at 2x512
   lanes with cap 40 — with both launch counters read around the timed run;
   the failing lanes are checked against ``fixtures/tail_verdict.json``;
   64 lanes are cross-checked against the port's plain path on the CPU in
   f64: the card's f64 run, the main run's f32 answers and the plain path
   in f32 on the CPU;
4. one ``{"kernels": [...]}`` line, and as the last line
   ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero without the last line.  With no CUDA
device, or outside a checkout of the repository, it exits 2.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

B = 16384                          # lanes of the bench workload
N_CHECK = 64                       # lanes cross-checked on the CPU in f64

TOL_F64 = 1e-10
TOL_F32 = {"rk4_stage_jac": 1e-4, "riccati_kkt": 1e-3}
# Converged U against the CPU f64 path, over the input box.  Two f64 runs
# differ only in rounding order and stop on the same iterate: U_TOL.  An f32
# run measures its KKT error with f32 rounding, and near the 1e-3 tolerance
# that decides on which iteration a lane stops.  A lane that stops on the
# same iteration as the f64 run is held to U_TOL too.  A lane that stops on
# another has taken more (or fewer) steps along a flat valley of the cost,
# and is held to U_TOL_MOVED: above the largest such move of the port's f32
# runs on these 64 lanes, on the card and on the CPU (PERF.md, section 2).
U_TOL = 1e-2
U_TOL_MOVED = 3e-2
OK_FRACTION_MIN = 0.998
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_FLOPS = {"float32": 67e12, "float64": 34e12}   # without tensor cores


def log(msg):
    print(msg, flush=True)


def nerr(a, b):
    """max |a-b| / (1+|b|) over finite reference entries."""
    a, b = a.double(), b.double()
    return float(((a - b).abs() / (1 + b.abs())).max()) if a.numel() else 0.0


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def sweep_inputs(dtype, device, clip_lo, clip_hi, seed=1):
    import torch

    from mpc_code_tpu_torch.examples.bench_workload import N, XHI, XLO

    rng = np.random.default_rng(seed)
    xs = rng.uniform(XLO, XHI, size=(B, N, 3))
    us = rng.uniform([295.0, 0.0], [305.0, 0.25], size=(B, N, 2))
    pxs = rng.normal(size=(B, N, 3)) * 1e-3
    t = np.zeros(B)
    h = np.full(B, 0.2)
    d = np.stack([np.zeros(B), rng.uniform(0.08, 0.12, B)], 1)
    kw = dict(dtype=dtype, device=device)
    arrs = [torch.as_tensor(a, **kw) for a in (xs, us, pxs, t, h, d)]
    # lanes whose state sits exactly on a clip bound (F1): the bounds the
    # guard applies, as the working dtype sees them
    clip_lanes = [0, 1, 2, 3]
    clip_lo = torch.as_tensor(clip_lo, **kw)
    clip_hi = torch.as_tensor(clip_hi, **kw)
    arrs[0][0, :, 1] = clip_lo[1]
    arrs[0][1, :, 0] = clip_hi[0]
    arrs[0][2, :, 2] = clip_lo[2]
    arrs[0][3, :, 1] = clip_hi[1]
    return arrs, clip_lanes


def riccati_inputs(dtype, device, nxa=3, nu=2, seed=2):
    import torch

    from mpc_code_tpu_torch.examples.bench_workload import N

    rng = np.random.default_rng(seed)
    nz = nxa + nu
    M = rng.normal(size=(B, N, nz, nz)) * 0.5
    Hs = M @ np.swapaxes(M, -1, -2) + 0.1 * np.eye(nz)
    q = rng.normal(size=(B, N, nz))
    A = 0.9 * np.eye(nxa) + 0.1 * rng.normal(size=(B, N, nxa, nxa))
    Bm = rng.normal(size=(B, N, nxa, nu)) * 0.5
    rd = rng.normal(size=(B, N, nxa)) * 0.1
    MP = rng.normal(size=(B, nxa, nxa))
    PN = MP @ np.swapaxes(MP, -1, -2) + np.eye(nxa)
    pN = rng.normal(size=(B, nxa))
    delta = np.zeros(B)
    bad_lane = 7
    Hs[bad_lane, N - 1, nxa:, nxa:] = -1e3 * np.eye(nu)   # indefinite Quu
    kw = dict(dtype=dtype, device=device)
    return ([torch.as_tensor(a, **kw) for a in (Hs, q, A, Bm, rd, PN, pN, delta)],
            bad_lane)


def kernel_phase(dev, socp, results):
    import torch

    from mpc_code_tpu_torch.examples.bench_workload import MX, N
    from mpc_code_tpu_torch.ops import sweep_cuda
    from mpc_code_tpu_torch.solver import riccati_kernel as rk

    failures = []
    sweep = socp.sweep
    for dtype in (torch.float64, torch.float32):
        tname = str(dtype).replace("torch.", "")
        # --- kernel 1: RK4 stage-Jacobian sweep
        arrs, clip_lanes = sweep_inputs(dtype, dev, sweep.clip_lo, sweep.clip_hi)
        got = sweep(*arrs)
        ref = sweep.plain(*arrs)
        torch.cuda.synchronize()
        err = max(nerr(g, r) for g, r in zip(got, ref))
        err_clip = max(nerr(g[clip_lanes], r[clip_lanes]) for g, r in zip(got, ref))
        abs_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        planes = sweep.pack(*arrs)
        ms = cuda_ms(lambda: sweep.launch_planes(planes), 20)
        wrap_ms = cuda_ms(lambda: sweep(*arrs), 10)
        plain_ms = cuda_ms(lambda: sweep.plain(*arrs), 2)
        nx, nu, npx, nd = 3, 2, 3, 2
        byt = sweep_cuda.sweep_bytes(B, N, nx, nu, nd, npx, arrs[0].element_size())
        ops_lane = sweep_cuda.sweep_ops_per_lane(
            sweep.f, nx, nu, MX, sweep.clip_lo, sweep.clip_hi)
        ops = B * N * ops_lane
        t_b, t_o = byt / H100_BYTES_PER_S * 1e3, ops / H100_FLOPS[tname] * 1e3
        tol = TOL_F64 if dtype == torch.float64 else TOL_F32["rk4_stage_jac"]
        log(f"# kernel rk4_stage_jac {tname}: max_norm_err={err:.3e} "
            f"clip_lanes={err_clip:.3e} max_abs_err={abs_err:.3e} (tol {tol:g}) "
            f"kernel_ms={ms:.4f} wrapper_ms={wrap_ms:.4f} plain_ms={plain_ms:.3f} "
            f"bound_ms={max(t_b, t_o):.4f} (bytes {t_b:.4f}, ops {t_o:.4f}; "
            f"{ops_lane} operations per lane)")
        if not (err <= tol and err_clip <= tol):
            failures.append(f"rk4_stage_jac {tname} error {err:.3e} > {tol:g}")
        results["rk4_stage_jac"][tname] = dict(
            max_norm_err=err, clip_norm_err=err_clip, max_abs_err=abs_err, ms=ms,
            wrapper_ms=wrap_ms, plain_ms=plain_ms, bytes_ms=t_b, ops_ms=t_o)

        # --- kernel 2: Riccati KKT
        nxa, nu = socp.nxa, socp.nu
        ins, bad_lane = riccati_inputs(dtype, dev, nxa, nu)
        got = rk.riccati_kkt(*ins, nxa=nxa, nu=nu)
        ref = rk.riccati_ref(*ins, nxa=nxa, nu=nu)
        torch.cuda.synchronize()
        ok_g, ok_r = got[0], ref[0]
        flags_equal = bool((ok_g == ok_r).all())
        okm = ok_r & ok_g
        err = max(nerr(g[okm], r[okm]) for g, r in zip(got[1:], ref[1:]))
        abs_err = max(float((g[okm] - r[okm]).abs().max())
                      for g, r in zip(got[1:], ref[1:]))
        planes = rk.pack(*ins, nxa=nxa, nu=nu)
        ms = cuda_ms(lambda: rk.launch_planes(planes), 20)
        wrap_ms = cuda_ms(lambda: rk.riccati_kkt(*ins, nxa=nxa, nu=nu), 10)
        plain_ms = cuda_ms(lambda: rk.riccati_ref(*ins, nxa=nxa, nu=nu), 2)
        byt = rk.riccati_bytes(B, N, nxa, nu, ins[0].element_size())
        ops = rk.riccati_ops(B, N, nxa, nu)
        t_b, t_o = byt / H100_BYTES_PER_S * 1e3, ops / H100_FLOPS[tname] * 1e3
        tol = TOL_F64 if dtype == torch.float64 else TOL_F32["riccati_kkt"]
        log(f"# kernel riccati_kkt {tname}: max_norm_err={err:.3e} "
            f"max_abs_err={abs_err:.3e} (tol {tol:g}) ok_flags_equal={flags_equal} "
            f"bad_lane_ok={bool(ok_g[bad_lane])} n_not_ok={int((~ok_r).sum())} "
            f"kernel_ms={ms:.4f} wrapper_ms={wrap_ms:.4f} plain_ms={plain_ms:.3f} "
            f"bound_ms={max(t_b, t_o):.4f} (bytes {t_b:.4f}, ops {t_o:.4f})")
        if not (err <= tol and flags_equal and not bool(ok_g[bad_lane])):
            failures.append(f"riccati_kkt {tname}: err {err:.3e} (tol {tol:g}), "
                            f"ok flags equal {flags_equal}")
        results["riccati_kkt"][tname] = dict(
            max_norm_err=err, max_abs_err=abs_err, ms=ms, wrapper_ms=wrap_ms,
            plain_ms=plain_ms, bytes_ms=t_b, ops_ms=t_o)
    return failures


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------


def profile_pass1(cfg, model, solve, x0s):
    """One pass-1 solve of the whole batch under torch.profiler: device
    busy share (summed kernel time over the profiled wall time), kernel
    launches per IPM iteration and the kernels that take the most time.
    Raises when the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mpc_code_tpu_torch.examples.bench_workload import (
        MAXIT1, U_SS, bench_params, warm_start,
    )

    nb = x0s.shape[0]
    us_b = torch.as_tensor(U_SS, dtype=x0s.dtype, device=x0s.device).expand(nb, cfg.nu)
    X0, U0 = warm_start(cfg, model, x0s, us_b)
    par = bench_params(cfg, x0s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = solve(par, X0, U0, max_iter=MAXIT1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_it = int(r.iters.max())
    kern = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy = sum(dev_us(e) for e in kern) / 1e6
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    top = sorted(kern, key=dev_us, reverse=True)[:6]
    return {"wall_s": wall, "iterations": n_it, "device_busy_s": busy,
            "device_busy_share": busy / wall,
            "kernel_launches_per_iteration": sum(e.count for e in kern) / max(n_it, 1),
            "top_kernels_ms": {e.key[:60]: dev_us(e) / 1e3 for e in top}}


def cross_check(name, run, ref, f32):
    """Hold one run of the check lanes against the CPU f64 run.  ``run`` and
    ``ref`` are (status, iters, kkt, U).  At most one lane may differ in
    converged status; converged ``U`` must agree to U_TOL of the input box,
    or, in an f32 run on a lane that stopped on another iteration than the
    reference, to U_TOL_MOVED.  Returns (failures, report)."""
    from mpc_code_tpu_torch.examples.bench_workload import U_BOX

    (st_x, it_x, kkt_x, U_x), (st_c, it_c, kkt_c, U_c) = run, ref
    conv_x, conv_c = st_x != 2, st_c != 2
    n_diff = int((conv_x != conv_c).sum())
    both = conv_x & conv_c
    du = (np.abs(U_x - U_c) / U_BOX).max(axis=(1, 2))
    same = both & (it_x == it_c)
    moved = both & (it_x != it_c) if f32 else np.zeros_like(both)
    du_same = float(du[both & ~moved].max()) if (both & ~moved).any() else 0.0
    du_moved = float(du[moved].max()) if moved.any() else 0.0
    log(f"# cpu f64 cross-check, {name} ({len(st_x)} lanes): converged "
        f"{int(conv_x.sum())} vs cpu {int(conv_c.sum())}, differ={n_diff}; "
        f"max |dU|/box: {du_same:.3e} over {int((both & ~moved).sum())} lanes "
        f"({int(same.sum())} stopped on the same iteration, tol {U_TOL:g}), "
        f"{du_moved:.3e} over {int(moved.sum())} that stopped on another "
        f"(tol {U_TOL_MOVED:g})")
    for i in np.where(both & (du > U_TOL))[0]:
        log(f"#   {name}, lane {i}: |dU|/box {du[i]:.3e}, iterations {it_x[i]} vs cpu "
            f"{it_c[i]}, kkt {kkt_x[i]:.4e} vs cpu {kkt_c[i]:.4e}")
    failures = []
    if n_diff > 1 or not (du_same <= U_TOL and du_moved <= U_TOL_MOVED):
        failures.append(f"cpu cross-check, {name}: {n_diff} status differences, "
                        f"max dU/box {du_same:.3e} (tol {U_TOL:g}), on lanes that "
                        f"stopped elsewhere {du_moved:.3e} (tol {U_TOL_MOVED:g})")
    return failures, dict(status_differ=n_diff, max_dU_over_box=du_same,
                          max_dU_over_box_moved=du_moved,
                          lanes_moved=int(moved.sum()))


def slice_phase(dev, problem, launches):
    import torch

    from mpc_code_tpu_torch.examples.bench_workload import (
        MX, N, draw_x0, make_problem, run_pipeline,
    )
    from mpc_code_tpu_torch.ops import sweep_cuda
    from mpc_code_tpu_torch.solver import riccati_kernel as rk

    failures = []
    cfg, model, socp, solve = problem
    x0s = draw_x0(B, dev)

    t0 = time.perf_counter()
    run_pipeline(cfg, model, solve, x0s)      # warm-up run
    log(f"# slice warm-up run: {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats(dev)
    sweep_cuda.LAUNCHES = 0
    rk.LAUNCHES = 0
    status, iters, feas, kkt, U, times = run_pipeline(cfg, model, solve, x0s)
    launches["rk4_stage_jac"] = sweep_cuda.LAUNCHES
    launches["riccati_kkt"] = rk.LAUNCHES
    ok = status != 2
    n_ok = int(ok.sum())
    ok_fraction = n_ok / B
    report = dict(
        batch=B, N=N, Mx=MX, ok=n_ok, ok_fraction=ok_fraction,
        solves_per_s=n_ok / times["total_s"],
        median_iters=float(np.median(iters)),
        max_feas_ok=float(feas[ok].max()) if n_ok else float("inf"),
        kkt_ok_p50=float(np.percentile(kkt[ok], 50)) if n_ok else float("inf"),
        launches=dict(launches),
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
        **{k: (round(v, 6) if isinstance(v, float) else v)
           for k, v in times.items()})
    log("# slice " + json.dumps(report))
    if ok_fraction < OK_FRACTION_MIN:
        failures.append(f"ok_fraction {ok_fraction:.5f} < {OK_FRACTION_MIN}")
    if min(launches.values()) <= 0:
        failures.append(f"a kernel was not launched on the main path: {launches}")

    report["profile"] = profile_pass1(cfg, model, solve, x0s)
    log("# profile " + json.dumps(report["profile"]))

    # the failing lanes against the classified tail (bench.py:397-429)
    tv_path = os.path.join(ROOT, "fixtures", "tail_verdict.json")
    bad_now = {int(i) for i in np.where(~ok)[0]}
    if os.path.exists(tv_path):
        with open(tv_path) as f:
            tv = json.load(f)
        classified = {int(lane["idx"]) for lane in tv.get("lanes", [])}
        log(f"# tail: failed {sorted(bad_now)}; classified physically "
            f"infeasible {sorted(classified)}; unclassified "
            f"{sorted(bad_now - classified)}")
    else:
        log(f"# tail: failed {sorted(bad_now)} (no tail_verdict.json)")

    # the first N_CHECK lanes against the port's plain path on the CPU in
    # f64: the card's path run in f64 (both kernels in f64), the main run's
    # f32 answers, and the plain path in f32 on the CPU
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    ccfg, cmodel, _, csolve = make_problem(cpu)
    runs = {}
    for name, (c, m, slv, x0) in {
            "cpu f64": (ccfg, cmodel, csolve, draw_x0(N_CHECK, cpu, dtype=torch.float64)),
            "gpu f64": (cfg, model, solve, draw_x0(N_CHECK, dev, dtype=torch.float64)),
            "cpu f32": (ccfg, cmodel, csolve, draw_x0(N_CHECK, cpu))}.items():
        st, it, _, kk, Ux, _ = run_pipeline(c, m, slv, x0, rescue_cap=8)
        runs[name] = (st, it, kk, Ux)
    runs["gpu f32"] = (status[:N_CHECK], iters[:N_CHECK], kkt[:N_CHECK], U[:N_CHECK])
    for name in ("gpu f64", "gpu f32", "cpu f32"):
        fails, report[f"xcheck_{name.replace(' ', '_')}"] = cross_check(
            name, runs[name], runs["cpu f64"], f32=name.endswith("f32"))
        failures += fails
    log(f"# cpu f64 cross-check: {time.perf_counter() - t0:.1f} s")
    return failures, report


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "mpc_code_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(mpc_code_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    log(card)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from mpc_code_tpu_torch.device import pin_fp32_precision
    from mpc_code_tpu_torch.examples.bench_workload import make_problem
    from mpc_code_tpu_torch.solver import riccati_kernel as rk

    pin_fp32_precision()       # as bench.py:40-42 pins the matmul precision
    dev = torch.device("cuda")
    failures = []
    results = {"rk4_stage_jac": {}, "riccati_kkt": {}}
    launches = {"rk4_stage_jac": 0, "riccati_kkt": 0}
    report = {}
    try:
        problem = make_problem(dev)
        cfg, model, socp, _ = problem
        sweep = socp.sweep
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(2) as ex:
            jobs = [ex.submit(sweep.build, cfg.nx, cfg.nu, cfg.nd, cfg.npx),
                    ex.submit(rk.build_kernel, socp.nxa, socp.nu)]
            built = [j.result() for j in jobs]
        log(f"# build: both kernels in {time.perf_counter() - t0:.1f} s")
        for b in built:
            for line in b.log.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"#   {os.path.basename(b.path)}: {line.strip()}")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED in set-up/build", file=sys.stderr)
        return 1

    for name, phase in (("kernel", lambda: kernel_phase(dev, socp, results)),
                        ("slice", lambda: slice_phase(dev, problem, launches))):
        try:
            out = phase()
            if name == "slice":
                out, report = out
            failures += out
        except Exception:
            traceback.print_exc()
            failures.append(f"{name} phase raised")

    kernels = []
    meta = {"rk4_stage_jac": ("mpc_code_tpu_torch/csrc/rk4_stage_jac.cu",
                              "mpc_code_tpu/ops/sweep_pallas.py:241"),
            "riccati_kkt": ("mpc_code_tpu_torch/csrc/riccati_kkt.cu",
                            "mpc_code_tpu/solver/riccati_kernel.py:92")}
    for name, (src, repl) in meta.items():
        r32 = results[name].get("float32", {})
        r64 = results[name].get("float64", {})
        tb, to = r32.get("bytes_ms"), r32.get("ops_ms")
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=repl,
            launches=launches[name], max_abs_err=r32.get("max_abs_err"),
            ms=r32.get("ms"), plain_ms=r32.get("plain_ms"),
            bound_ms=None if tb is None else max(tb, to),
            bound_by=None if tb is None else ("bytes" if tb >= to else "operations"),
            library_ms=None, dtype="float32",
            wrapper_ms=r32.get("wrapper_ms"),
            max_norm_err_f32=r32.get("max_norm_err"),
            max_norm_err_f64=r64.get("max_norm_err"),
            ms_f64=r64.get("ms"), plain_ms_f64=r64.get("plain_ms")))
    print(json.dumps({"kernels": kernels}), flush=True)
    if failures:
        for f in failures:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
