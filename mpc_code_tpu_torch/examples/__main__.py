"""Command line for the example configs (port of ``mpc_code_tpu/examples/__main__.py``):
the analog of editing the hard-coded example name in the reference driver
(MPC_code.py:25) and running it, through the host loop ``ClosedLoop``.

    python -m mpc_code_tpu_torch.examples enmpc [--nsim 50] [--n 20] [--plots DIR]
    python -m mpc_code_tpu_torch.examples enmpc --cpu --nsim 2 --save run.npz
    python -m mpc_code_tpu_torch.examples --list

It runs on the card in f64 (raising without one), or with ``--cpu`` on the
CPU in f64, as the JAX command's ``--cpu`` does.
"""

import argparse
import sys

NAMES = ["lmpc_wb", "lmpc_cstr", "lmpc_nlplant", "lmpcxp_nlplant",
         "nmpc", "nmpc_dis", "enmpc"]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mpc_code_tpu_torch.examples")
    ap.add_argument("example", nargs="?", choices=NAMES)
    ap.add_argument("--list", action="store_true", help="list example configs")
    ap.add_argument("--nsim", type=int, default=None, help="simulation length")
    ap.add_argument("--n", type=int, default=None, help="prediction horizon")
    ap.add_argument("--plots", default=None, help="write PDF plots to this dir")
    ap.add_argument("--save", default=None, help="save history NPZ to this path")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU in float64 (default: the card, float64)")
    args = ap.parse_args(argv)

    if args.list or args.example is None:
        print("\n".join(NAMES))
        return 0

    import numpy as np

    from mpc_code_tpu_torch.loop import ClosedLoop

    mod = __import__(f"mpc_code_tpu_torch.examples.{args.example}",
                     fromlist=["make_config"])
    cfg = mod.make_config(**({"Nsim": args.nsim} if args.nsim else {}))
    if args.n:
        cfg = cfg.replace(N=args.n)

    loop = ClosedLoop(cfg, device="cpu" if args.cpu else None)
    H = loop.run(verbose=True)

    ss = np.asarray(H["STATUS_SS"])
    dy = np.asarray(H["STATUS_DYN"])
    print(f"\n{args.example}: {cfg.Nsim} steps on {loop.device} | "
          f"target solves ok {int((ss != 2).sum())}/{len(ss)} | "
          f"OCP solves ok {int((dy != 2).sum())}/{len(dy)}")
    if len(H["Yp"]):
        print(f"final y = {np.round(H['Yp'][-1], 5).tolist()}")
    if len(H["U"]):
        print(f"final u = {np.round(H['U'][-1], 5).tolist()}")

    if args.save:
        from mpc_code_tpu_torch.utils.io import save_history

        save_history(args.save, {k: v for k, v in H.items() if len(np.atleast_1d(v))},
                     h=cfg.h)
        print(f"history -> {args.save}")
    if args.plots:
        from mpc_code_tpu_torch.utils.plotting import plot_history

        plot_history(H, cfg.h, args.plots, estimating=cfg.estimating)
        print(f"plots -> {args.plots}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
