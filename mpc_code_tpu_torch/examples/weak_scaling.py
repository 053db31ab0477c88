"""Weak-scaling harness: batched CSTR NMPC solves split over a mesh of ranks.

Port of ``tools/weak_scaling.py``: the bench's cold CSTR NMPC solves (N=50
by default, RK4, the saturation guard; the structured solver under
Gauss-Newton, cap 40, tol 1e-3) at a fixed per-rank batch while the mesh
grows (1, 2, 4, ... ranks of the launched world, as JAX sweeps
``devices[:nd]``), with each count's throughput and its weak-scaling
efficiency against the first count.  Ranks outside a count's mesh wait.
Rank 0 prints one JSON line per count, as the JAX tool does.

    # one card
    python -m mpc_code_tpu_torch.examples.weak_scaling
    # every card of a host
    torchrun --nproc-per-node 4 -m mpc_code_tpu_torch.examples.weak_scaling
    # explicit addresses (one command per rank)
    python -m mpc_code_tpu_torch.examples.weak_scaling --distributed \\
        --coordinator 127.0.0.1:8476 --num-processes 2 --process-id <i>

``--cpu`` runs the same path on the CPU under gloo: a check of the
mechanics, not a measurement (``--mx`` and ``--max-iter`` cut the RK4
sub-steps and the cap for a quick one).  A batch's time is the slowest
rank's.
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
    ap.add_argument("--per-device", type=int, default=1024)
    ap.add_argument("--n", type=int, default=50, help="horizon")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--mx", type=int, default=10, help="RK4 sub-steps (the bench's 10)")
    ap.add_argument("--max-iter", type=int, default=40, help="the solver's cap")
    ap.add_argument("--device-counts", type=int, nargs="*", default=None,
                    help="mesh sizes to sweep (default: 1, 2, 4, ..., all)")
    ap.add_argument("--cpu", action="store_true", help="gloo on the CPU (mechanics)")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--coordinator", default="127.0.0.1:8476")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.device import pin_fp32_precision
    from mpc_code_tpu_torch.examples.bench_workload import (
        U_SS, XHI, XLO, bench_params, make_problem, warm_start,
    )
    from mpc_code_tpu_torch.parallel.mesh import (
        init_distributed, make_mesh, mesh_device, shard_batch,
    )
    from mpc_code_tpu_torch.solver.riccati import make_structured_solver

    device = "cpu" if args.cpu else None
    if args.distributed:
        init_distributed(coordinator_address=args.coordinator,
                         num_processes=args.num_processes, process_id=args.process_id,
                         device=device)
    elif "WORLD_SIZE" in os.environ:          # launched by torchrun
        init_distributed(device=device)
    if not args.cpu:
        pin_fp32_precision()
    world_mesh = make_mesh(device=device)
    dev = mesh_device(world_mesh)
    world, rank = dist.get_world_size(), dist.get_rank()

    N = args.n
    cfg, model, socp, _ = make_problem(dev, Nh=N, Mx=args.mx)
    solve = make_structured_solver(socp, SolverOptions(
        max_iter=args.max_iter, tol=1e-3, constr_viol_tol=1e-3, hessian="gauss_newton"))

    def lanes(x0):
        u_ws = torch.as_tensor(U_SS, dtype=x0.dtype, device=dev).expand(len(x0), cfg.nu)
        X0, U0 = warm_start(cfg, model, x0, u_ws, N)
        return solve(bench_params(cfg, x0, N), X0, U0)

    counts = args.device_counts
    if not counts:
        counts, c = [], 1
        while c <= world:
            counts.append(c)
            c *= 2
        if counts[-1] != world:
            counts.append(world)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(0)
    results, base = [], None
    for nd in counts:
        if nd > world:
            continue
        mesh = make_mesh(nd, device=device)
        B = args.per_device * nd
        x0s = rng.uniform(XLO, XHI, size=(B, 3)).astype(np.float32)
        if rank < nd:
            group = mesh.get_group("batch")

            def timed(x0):
                xb = shard_batch(torch.as_tensor(x0), mesh)
                sync()
                t0 = time.perf_counter()
                lanes(xb).U.sum().item()
                # the batch is done when its slowest rank is
                dt = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                                  device=dev)
                dist.all_reduce(dt, op=dist.ReduceOp.MAX, group=group)
                return float(dt[0])

            compile_s = timed(x0s)
            best = min(timed(x0s + np.float32(1e-4 * (r + 1))) for r in range(args.reps))
            tput = B / best
            if base is None:
                base = tput / nd        # per-rank reference at the first count
            eff = tput / (base * nd)
            results.append(dict(devices=nd, batch=B, best_s=round(best, 4),
                                compile_s=round(compile_s, 1), solves_per_s=round(tput, 1),
                                weak_scaling_eff=round(eff, 4)))
            if rank == 0:
                print(f"# devices={nd} B={B} best={best * 1000:.1f}ms "
                      f"tput={tput:.0f}/s eff={eff:.3f}", file=sys.stderr, flush=True)
        dist.barrier()
    if rank == 0:
        for r in results:
            print(json.dumps(r), flush=True)
    dist.destroy_process_group()
    return results


if __name__ == "__main__":
    main()
