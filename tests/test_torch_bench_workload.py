"""The port's bench workload (``examples/bench_workload.py``) on the CPU at a
small size: the rescue merge of the two-pass pipeline gives each failed lane
the answer of a direct solve from the first start that converges, and the
entry points run on the card unless asked not to."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

NH, MX, LANES = 6, 2, 3


def test_pipeline_merges_the_rescue_answers():
    from mpc_code_tpu_torch.examples.bench_workload import (
        MAXIT1, MAXIT_R, U_COOL, U_SS, bench_params, draw_x0, make_problem,
        run_pipeline, warm_start,
    )

    cpu = torch.device("cpu")
    cfg, model, _, solve = make_problem(cpu, Nh=NH, Mx=MX)
    x0s = draw_x0(LANES, cpu, dtype=torch.float64)

    def solve_failing(par, X0, U0, max_iter):
        """Pass 1 reports every lane failed; in the rescue, the steady
        start of lane 0 reports failed, so lane 0 takes coolhold."""
        r = solve(par, X0, U0, max_iter=max_iter)
        st = r.status.clone()
        if max_iter == MAXIT1:
            st[:] = 2
        else:
            half = X0.shape[0] // 2
            st[:half][(par["x0"][:half] == x0s[0]).all(1)] = 2
        return r._replace(status=st)

    # a rescue cap of 2 lanes takes two rescue calls, the second padded
    status, iters, _, kkt, U, times = run_pipeline(
        cfg, model, solve_failing, x0s, rescue_cap=2, Nh=NH)
    assert times["rescue_lanes"] == LANES and times["rescue_calls"] == 2

    direct = {}
    for name, u, cap in (("pass1", U_SS, MAXIT1), ("steady", U_SS, MAXIT_R),
                         ("coolhold", U_COOL, MAXIT_R)):
        uw = torch.as_tensor(u, dtype=x0s.dtype).expand(LANES, 2)
        X0, U0 = warm_start(cfg, model, x0s, uw, NH)
        direct[name] = solve(bench_params(cfg, x0s, NH), X0, U0, max_iter=cap)
    for i in range(LANES):
        steady = i != 0 and int(direct["steady"].status[i]) != 2
        r = direct["steady"] if steady else direct["coolhold"]
        assert status[i] == int(r.status[i])
        np.testing.assert_allclose(U[i], r.U[i].numpy(), rtol=0, atol=1e-9)
        np.testing.assert_allclose(kkt[i], float(r.kkt_err[i]), rtol=1e-9)
        want = int(direct["pass1"].iters[i]) + int(direct["steady"].iters[i])
        if not steady:
            want += int(direct["coolhold"].iters[i])
        assert iters[i] == want


def test_bench_entry_points_default_to_the_card():
    from mpc_code_tpu_torch.examples.bench_workload import draw_x0, make_problem

    if torch.cuda.is_available():
        assert draw_x0(2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            draw_x0(2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_problem(Nh=NH, Mx=MX)
    x0 = draw_x0(4, "cpu")
    assert x0.dtype == torch.float32 and x0.shape == (4, 3)
    np.testing.assert_array_equal(x0.numpy(), draw_x0(4, "cpu", dtype=torch.float64).numpy())
