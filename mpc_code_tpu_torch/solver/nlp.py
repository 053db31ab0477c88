"""Parametric NLP problem specification and result types.

Port of ``mpc_code_tpu/solver/nlp.py``: the same ``nlpsol``-style problem
form (reference: Control_Calc.py:258) and the same status codes, and the
solvers' debug printing (``debug_lines``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch


@dataclass(frozen=True)
class NLP:
    """Static problem definition: callables + sizes."""

    f: Callable  # f(w, p) -> scalar
    g: Callable  # g(w, p) -> (ng,) tensor (ng may be 0)
    nw: int
    ng: int


class NLPBounds(NamedTuple):
    lbw: Any
    ubw: Any
    lbg: Any
    ubg: Any


# Solver return statuses (reference analog: IPOPT return_status strings the
# driver checks at MPC_code.py:714, 786).
STATUS_SOLVED = 0          # KKT error <= tol
STATUS_ACCEPTABLE = 1      # iteration limit but feasible
STATUS_INFEASIBLE = 2      # terminated with constraint violation


class IPMResult(NamedTuple):
    w: Any          # primal solution (nw,)
    f: Any          # objective value
    lam_g: Any      # constraint multipliers (ng,)
    status: Any     # int32 status code (see above)
    iters: Any      # iterations used
    kkt_err: Any    # final unscaled KKT error (mu = 0)
    feas_err: Any   # final constraint violation (inf-norm)


def debug_lines(fmt: str, **lanes) -> None:
    """Print ``fmt`` once per lane, in lane order, from per-lane tensors
    (B,): ``jax.debug.print`` under ``vmap`` prints every lane's line.
    The values come to the host in one copy; booleans print as JAX prints
    them (True/False), integers as integers."""
    keys = list(lanes)
    vals = torch.stack([lanes[k].detach().to(torch.float64) for k in keys]).cpu().tolist()
    kinds = [lanes[k].dtype for k in keys]
    for b in range(len(vals[0])):
        row = {}
        for k, kind, v in zip(keys, kinds, vals):
            x = v[b]
            row[k] = (bool(x) if kind == torch.bool else
                      int(x) if not kind.is_floating_point else x)
        print(fmt.format(**row), flush=True)
