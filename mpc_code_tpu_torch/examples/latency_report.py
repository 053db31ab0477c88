"""Per-step solve-latency report: p50/p90/p99 of the target and OCP solves against h.

Port of ``tools/latency_report.py``.  It runs an example through the host
loop ``ClosedLoop`` and reports percentiles of the per-step target
(``TIME_SS``) and OCP (``TIME_DYN``) solve wall times, which the reference
collects but never reports (MPC_code.py:703-711, 775-783), beside the
sampling period ``h``.  The first step is left out: it builds the kernels
and pays the card's first-use set-up.  A closed loop whose plant state sits
on its saturation guard diverged, and then the report refuses to print.

Usage: python -m mpc_code_tpu_torch.examples.latency_report [example] [Nsim] [N] [--cpu]

It runs on the card in f64, or with ``--cpu`` on the CPU.
"""

from __future__ import annotations

import importlib
import sys

import numpy as np


def report(name="lmpc_wb", Nsim=50, N=None, device=None):
    """The report's lines for ``examples/<name>.py`` run for ``Nsim``
    steps (horizon ``N`` if given)."""
    from mpc_code_tpu_torch.loop import ClosedLoop

    mod = importlib.import_module(f"mpc_code_tpu_torch.examples.{name}")
    cfg = mod.make_config(Nsim=Nsim)
    if N:
        cfg = cfg.replace(N=N)
    H = ClosedLoop(cfg, device=device).run()
    lo = getattr(cfg.plant, "clip_lo", None)
    if lo is not None:
        Xp = np.asarray(H["Xp"]).reshape(Nsim, -1)
        lo = np.asarray(lo, float)
        hi = np.asarray(cfg.plant.clip_hi, float)
        margin = 1e-6 * np.maximum(1.0, np.abs(hi - lo))
        saturated = (Xp <= lo + margin) | (Xp >= hi - margin)
        if saturated.any():
            k_bad, i_bad = np.argwhere(saturated)[0]
            raise SystemExit(
                f"plant state hit its saturation bound (step {k_bad}, state "
                f"{i_bad}, value {Xp[k_bad, i_bad]:.6g}): the closed loop "
                "diverged; latency percentiles would be meaningless")
    lines = []
    for key, label in (("TIME_SS", "target"), ("TIME_DYN", "OCP")):
        t = np.asarray(H[key])[1:]
        if not len(t):
            continue
        lines.append(f"{name} {label}: p50={np.percentile(t, 50) * 1e3:.1f}ms "
                     f"p90={np.percentile(t, 90) * 1e3:.1f}ms "
                     f"p99={np.percentile(t, 99) * 1e3:.1f}ms "
                     f"(sampling period h={cfg.h}s -> budget {cfg.h * 1e3:.0f}ms)")
    return lines


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    device = "cpu" if "--cpu" in argv else None
    pos = [a for a in argv if a != "--cpu"]
    name = pos[0] if len(pos) > 0 else "lmpc_wb"
    Nsim = int(pos[1]) if len(pos) > 1 else 50
    N = int(pos[2]) if len(pos) > 2 else None
    for line in report(name, Nsim, N, device):
        print(line, flush=True)


if __name__ == "__main__":
    main()
