"""Closed-loop result plotting (port of ``mpc_code_tpu/utils/plotting.py``,
a copy: numpy, and matplotlib imported inside the functions).

Counterpart of the reference's `makeplot` (Utilities.py:422-496)
and the driver's plotting block (MPC_code.py:897-930): per-variable
time-series PDFs of actual vs target vs setpoint, step plots for inputs,
saved under a figure path.  History enters as the stacked arrays the
simulator returns (the reference reshapes interleaved vectors instead).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def makeplot(tsim, X1, label: str, pf: str = "./", X2=None, X3=None,
             pltopt: str = "-", lableg: str = "Target"):
    """Per-column comparison plots, saved as ``<pf><label><i>.pdf``.

    Mirrors the reference signature/semantics (Utilities.py:422-496):
    X1 actual, X2 optional target, X3 optional setpoint; `pltopt='steps'`
    draws step plots (inputs).  Returns the (nt, dim) arrays.
    """
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    tsim = np.asarray(tsim)
    X1 = np.atleast_2d(np.asarray(X1))
    if X1.shape[0] != tsim.size:
        X1 = X1.reshape(tsim.size, -1)
    sz = X1.shape[1]
    os.makedirs(pf, exist_ok=True)
    outs = [X1, None, None]
    extras = [x for x in (X2, X3) if x is not None]
    for k in range(sz):
        plt.figure()
        draw = plt.step if pltopt == "steps" else plt.plot
        draw(tsim, X1[:, k])
        for i_var, Xi in enumerate(extras):
            Xi = np.asarray(Xi).reshape(tsim.size, -1)
            draw(tsim, Xi[:, k])
            if i_var == 0:
                plt.legend(("Actual", lableg))
                outs[1] = Xi
            else:
                plt.legend(("Actual", "Target", "Set-Point"))
                outs[2] = Xi
        plt.xlabel("Time ")
        plt.ylabel(label + str(k + 1))
        plt.xlim(left=0, right=tsim[-1])
        plt.grid(True)
        plt.savefig(os.path.join(pf, f"{label}{k + 1}.pdf"), format="pdf",
                    transparent=True, bbox_inches="tight")
        plt.close()
    return outs


def plot_history(H: Dict[str, np.ndarray], h: float, pf: str = "./figures/",
                 estimating: bool = False, has_sp: Optional[bool] = None):
    """Reproduce the reference driver's full plot set (MPC_code.py:909-930)."""
    n = H["Yp"].shape[0]
    tsim = np.linspace(0, (n - 1) * h, n)
    if estimating:
        makeplot(tsim, H["X_HAT"], "State ", pf, H["Xp"], lableg="True Value")
        makeplot(tsim, H["Y_HAT"], "Output ", pf, H["Yp"], lableg="True Value")
        if H.get("X_KF") is not None and len(H["X_KF"]):
            makeplot(tsim, H["X_KF"], "KF State ", pf, H["Xp"], lableg="True Value")
    else:
        makeplot(tsim, H["X_HAT"], "State ", pf, H["XS"])
        makeplot(tsim, H["U"], "Input ", pf, H["US"], pltopt="steps")
        if has_sp is None:
            has_sp = len(H.get("Ysp", [])) > 0
        if has_sp:
            makeplot(tsim, H["Yp"], "Output ", pf, H["YS"], H["Ysp"])
        else:
            makeplot(tsim, H["Yp"], "Output ", pf, H["YS"])
    if len(H.get("D_HAT", [])):
        makeplot(tsim, H["D_HAT"], "Disturbance Estimate ", pf)
