"""Entry points: the one-card step check and the n-rank dry run.

The port's counterpart of ``__graft_entry__.py``:

- ``entry()`` returns ``(fn, example_args)``: one batched closed-loop MPC
  step (Kalman estimate, target NLP, OCP NLP, plant step per scenario) of
  ``examples/closed_loop_bench.py::small_cfg(N=8)`` and its initial carry
  of 4 lanes;
- ``dryrun_multichip(n)`` builds an n-rank mesh, splits the scenario
  batch over it and runs one full closed-loop step of that config, then
  one step of an estimator-rich config (the smooth MHE with its
  growing-horizon warmup and the economic ContForm OCP) under the same
  mesh.

Both run on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mpc_code_tpu_torch.examples.closed_loop_bench import YSP, small_cfg


def entry(device=None):
    """(fn, example_args): ``fn(carry) -> (x_next, u, status_dyn)``, one
    batched closed-loop step, with a carry of 4 lanes."""
    from mpc_code_tpu_torch.device import resolve_device
    from mpc_code_tpu_torch.loop.batched import init_carry, make_mpc_step

    dev = resolve_device(device)
    cfg = small_cfg(N=8)
    step = make_mpc_step(cfg, ysp=YSP, device=dev)

    def fn(carry):
        new_carry, out = step(carry)
        return new_carry.x, out.u, out.status_dyn

    B = 4
    x0s = np.tile(np.asarray(cfg.x0_p, float), (B, 1)) + 0.1 * np.arange(B)[:, None]
    return fn, (init_carry(cfg, x0s, device=dev),)


def dryrun_multichip(n_devices: int, device=None):
    """One closed-loop step of ``small_cfg(N=4)`` on 2n lanes split over an
    n-rank mesh, then one step of Ex_ENMPC at N=3 with N_mhe=3 on the same
    lanes' count.  Returns both runs' ``(final_carry, outputs)``, this
    rank's block of each."""
    from mpc_code_tpu_torch.examples.enmpc import make_config as make_enmpc
    from mpc_code_tpu_torch.parallel.mesh import batched_closed_loop, make_mesh

    cfg = small_cfg(N=4)
    mesh = make_mesh(n_devices, device=device)
    B = 2 * n_devices
    x0s = np.tile(np.asarray(cfg.x0_p, float), (B, 1)) + 0.05 * np.arange(B)[:, None]
    lin = batched_closed_loop(cfg, x0s, n_steps=1, mesh=mesh, ysp=YSP)
    assert lin[1].u.shape == (1, B // n_devices, cfg.nu)

    cfg_m = make_enmpc(Nsim=2).replace(N=3)
    cfg_m = cfg_m.replace(estimator=dataclasses.replace(cfg_m.estimator, N_mhe=3))
    x0m = np.tile(np.asarray(cfg_m.x0_p, float), (B, 1)) * (
        1.0 + 0.01 * np.arange(B)[:, None])
    mhe = batched_closed_loop(cfg_m, x0m, n_steps=1, mesh=mesh)
    assert mhe[1].u.shape == (1, B // n_devices, cfg_m.nu)
    return lin, mhe
