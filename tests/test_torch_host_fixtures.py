"""The reduced fixtures through the port's host loop ``ClosedLoop``, CPU, f64, no JAX.

``fixtures/lmpc_wb.npz`` (Nsim=25, N=15: the Luenberger observer) and
``fixtures/enmpc.npz`` (Nsim=8, N=8, N_mhe=5: the MHE, 'smooth', its
window by the structured IPM through ``MHERuntime``), at the sizes of
``tools/record_fixtures.py:28-36``, through the loop that recorded them:
every recorded key within the fixtures' 1e-4 bar
(``tests/test_fixtures.py:37``); measured 3.1e-15 and 6.1e-16.

About 45 s in one process on the CPU (the ENMPC fixture 37 s: its dense
OCP and target).
"""

import dataclasses as dc
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "fixtures")


@pytest.mark.parametrize("name,Nsim,N,N_mhe", [("lmpc_wb", 25, 15, None), ("enmpc", 8, 8, 5)],
                         ids=["lmpc_wb", "enmpc"])
def test_reduced_fixture(name, Nsim, N, N_mhe):
    from mpc_code_tpu_torch.loop import ClosedLoop

    mod = __import__(f"mpc_code_tpu_torch.examples.{name}", fromlist=["make_config"])
    cfg = mod.make_config(Nsim=Nsim).replace(N=N)
    if N_mhe is not None:
        cfg.estimator = dc.replace(cfg.estimator, N_mhe=N_mhe)
    H = ClosedLoop(cfg, device="cpu").run()
    ref = np.load(os.path.join(FIXTURES, f"{name}.npz"))
    assert int(ref["meta_Nsim"]) == Nsim and int(ref["meta_N"]) == N
    keys = [k[2:] for k in ref.files if k.startswith("H_")]
    assert {"U", "Yp", "D_HAT"} <= set(keys)
    for key in keys:
        dev = np.abs(H[key] - ref["H_" + key]).max()
        assert dev <= 1e-4, f"{name}: {key} deviates by {dev:.2e}"
