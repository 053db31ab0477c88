"""What kernels 1 and 3 read and write in place, CPU, torch only.

The RK4 stage-Jacobian sweep (kernel 1) and the discrete map's sweep
(kernel 3) read the solver's (B, N, ...) tensors where they lie, at their
strides, and write contiguous ``xf`` (B, N, nx), ``Jx`` (B, N, nx, nx) and
``Ju`` (B, N, nx, nu).  Here:

- ``LaneSweep.strides`` gives the launcher's strides in its order (two for
  a per-stage input, one for a per-scenario one), a view expanded over the
  batch and a slice of a wider tensor included, and raises on an input
  whose last dimension is not unit-stride;
- the structured solver hands both sweeps inputs they read in place on the
  CSTR and nmpc_dis paths (one iteration of each, tiny sizes);
- off the CPU the wrapper launches the kernel or raises: on a tensor that
  is not on a CUDA device it raises, and never runs the plain version.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _cstr_sweep():
    from mpc_code_tpu_torch.examples import bench_workload as bw

    return bw.make_problem("cpu", Nh=4, Mx=2)


def test_strides_in_launcher_order():
    socp = _cstr_sweep()[2]
    Bsz, N = 3, 4
    wide = torch.zeros(Bsz, N, 5, dtype=torch.float64)
    named = dict(xs=wide[..., :3], us=torch.zeros(Bsz, N, 2, dtype=torch.float64),
                 pxs=torch.zeros(N, 3, dtype=torch.float64).expand(Bsz, N, 3),
                 t=torch.zeros((), dtype=torch.float64).expand(Bsz),
                 h=torch.zeros(Bsz, dtype=torch.float64),
                 d=torch.zeros(2, dtype=torch.float64).expand(Bsz, 2))
    assert socp.sweep.strides(named) == [N * 5, 5, N * 2, 2, 0, 3, 0, 1, 0]
    assert socp.sweep.out_dims(3, 2, 2, 3) == ((3,), (3, 3), (3, 2))


def test_strides_raise_on_a_transposed_last_dimension():
    socp = _cstr_sweep()[2]
    Bsz, N = 3, 4
    named = dict(xs=torch.zeros(Bsz, 3, N, dtype=torch.float64).transpose(1, 2),
                 us=torch.zeros(Bsz, N, 2, dtype=torch.float64),
                 pxs=torch.zeros(Bsz, N, 3, dtype=torch.float64),
                 t=torch.zeros(Bsz, dtype=torch.float64),
                 h=torch.zeros(Bsz, dtype=torch.float64),
                 d=torch.zeros(Bsz, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="unit stride"):
        socp.sweep.strides(named)


def _record_sweep_inputs(monkeypatch):
    from mpc_code_tpu_torch.ops.lane_sweep import LaneSweep

    seen = []

    def call(self, *args):
        if self.in_place:
            names = self.stage_inputs + self.scalar_inputs + self.scenario_inputs
            seen.append((self.kernel, self.strides(dict(zip(names, args)))))
        return self.plain(*args)

    monkeypatch.setattr(LaneSweep, "__call__", call)
    return seen


def _solve_cstr():
    from mpc_code_tpu_torch.examples import bench_workload as bw

    cfg, model, _, solve = _cstr_sweep()
    x0 = bw.draw_x0(3, "cpu", dtype=torch.float64)
    X0, U0 = bw.warm_start(cfg, model, x0, torch.tensor(bw.U_SS).expand(3, 2), 4)
    solve(bw.bench_params(cfg, x0, 4), X0, U0, max_iter=1)


def _solve_nmpc_dis():
    from mpc_code_tpu_torch.examples import nmpc_dis_workload as dw

    prob = dw.make_problem("cpu", Nh=4)
    lanes = dw.draw_lanes(3, "cpu", dtype=torch.float64)
    cfg = prob.cfg
    xs = torch.as_tensor(np.asarray(cfg.x0_m, float)).expand(3, cfg.nx)
    us = torch.as_tensor(np.asarray(cfg.u0, float)).expand(3, cfg.nu)
    dw.solve_ocps(prob, lanes, xs, us)


@pytest.mark.parametrize("path,kernel", [("cstr", "rk4_stage_jac"),
                                         ("nmpc_dis", "map_stage_jac")])
def test_solver_hands_the_sweep_what_its_kernel_reads(path, kernel, monkeypatch):
    seen = _record_sweep_inputs(monkeypatch)
    {"cstr": _solve_cstr, "nmpc_dis": _solve_nmpc_dis}[path]()
    assert seen and all(k == kernel for k, _ in seen)


def test_rk4_wrapper_refuses_non_cuda_tensors(monkeypatch):
    socp = _cstr_sweep()[2]
    sweep = socp.sweep

    def no_plain(*a):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(sweep, "plain", no_plain)
    Bsz, N = 2, 4
    args = [torch.zeros(s, dtype=torch.float64, device="meta")
            for s in ((Bsz, N, 3), (Bsz, N, 2), (Bsz, N, 3), (Bsz,), (Bsz,), (Bsz, 2))]
    with pytest.raises(ValueError, match="CUDA"):
        sweep(*args)
