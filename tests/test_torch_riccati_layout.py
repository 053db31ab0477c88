"""The Riccati kernel's layout contract (kernel 2), CPU.

- ``launch_geometry``: a group of threads per lane within one warp, and a
  ring of shared-memory slots that fits a block (227 KB) with at least two
  slots, at each (N, nxa, nu) of the port's paths, in f32 and f64.
- ``check_inputs``, what the kernel's wrapper runs before a launch: it
  raises ``ValueError`` on a CPU tensor, a non-contiguous tensor, a wrong
  shape and mixed dtypes.
- The plain ``riccati_kkt`` against JAX's ``_riccati_ref`` under vmap at the
  quadruple tank's width (nxa, nu) = (8, 2), N=6, f64, to 1e-10.
- The structured solver hands ``riccati_kkt`` contiguous (B, N, ...)
  tensors on each path (CSTR Gauss-Newton and exact, ENMPC, nmpc_dis) when
  the sweeps return what their kernels' wrappers return on the card: views
  of lane-innermost planes for kernel 4, contiguous (B, N, ...) tensors
  for kernels 1, 3 and 5; and on the linear-model route, whose stage
  derivatives come from ``torch.func`` (``lmpc_nlplant``, ``lmpc_cstr``,
  under both Hessians; ROADMAP Queue 3, F11).  One iteration of each, tiny
  sizes.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

# CSTR, ENMPC, nmpc_dis; the LMPC loop (lmpc_nlplant), lmpc_wb and
# lmpcxp_nlplant; the bench port (closed_loop_bench)
PATH_SHAPES = [(50, 3, 2), (25, 2, 1), (50, 8, 2), (50, 5, 2), (50, 6, 2), (20, 3, 2)]
SMEM_LIMIT = 227 * 1024


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("N,nxa,nu", PATH_SHAPES)
def test_launch_geometry_fits(N, nxa, nu, itemsize):
    from mpc_code_tpu_torch.solver.riccati_kernel import launch_geometry

    geo = launch_geometry(N, nxa, nu, itemsize)
    assert 2 <= geo.depth <= N
    assert geo.smem <= SMEM_LIMIT
    # a group of threads per lane, one per row of P, within one warp
    assert nxa <= geo.group <= 32 and geo.group * geo.lanes == 32
    nz = nxa + nu
    slot = (nz * nz + nz + nxa * nxa + nxa * nu + nxa) * itemsize * geo.lanes
    assert geo.smem >= geo.depth * slot
    # deep enough for 4 KB in flight a warp, or as deep as allowed
    assert (geo.depth - 1) * slot >= 4 * 1024 or geo.depth == min(8, N)


def _inputs(Bsz, N, nxa, nu, seed=0, bad=None):
    rng = np.random.default_rng(seed)
    nz = nxa + nu
    M = rng.normal(size=(Bsz, N, nz, nz)) * 0.5
    Hs = M @ np.swapaxes(M, -1, -2) + 0.1 * np.eye(nz)
    if bad is not None:
        Hs[bad, 2, nxa:, nxa:] = -50.0 * np.eye(nu)
    q = rng.normal(size=(Bsz, N, nz))
    A = 0.9 * np.eye(nxa) + 0.1 * rng.normal(size=(Bsz, N, nxa, nxa))
    Bm = rng.normal(size=(Bsz, N, nxa, nu)) * 0.5
    rd = rng.normal(size=(Bsz, N, nxa)) * 0.1
    MP = rng.normal(size=(Bsz, nxa, nxa))
    PN = MP @ np.swapaxes(MP, -1, -2) + np.eye(nxa)
    pN = rng.normal(size=(Bsz, nxa))
    delta = np.full(Bsz, 1e-3)
    return Hs, q, A, Bm, rd, PN, pN, delta


def _bad_noncontiguous(ins):
    ins[2] = ins[2].transpose(-1, -2).contiguous().transpose(-1, -2)
    return ins, "contiguous"


def _bad_shape(ins):
    ins[1] = ins[1][:, :, :-1]
    return ins, "shape"


def _bad_dtype(ins):
    ins[4] = ins[4].float()
    return ins, "must be torch.float64"


def _cpu(ins):
    return ins, "CUDA"


@pytest.mark.parametrize("spoil", [_cpu, _bad_noncontiguous, _bad_shape, _bad_dtype])
def test_check_inputs_raises(spoil):
    from mpc_code_tpu_torch.solver import riccati_kernel as rk

    ins, match = spoil([torch.tensor(a) for a in _inputs(4, 5, 3, 2)])
    with pytest.raises(ValueError, match=match):
        rk.check_inputs(*ins, nxa=3, nu=2)
    with pytest.raises(ValueError, match=match):
        rk.riccati_kkt_cuda(*ins, nxa=3, nu=2)


@pytest.fixture(scope="module")
def wide():
    from mpc_code_tpu.solver.riccati_kernel import _riccati_ref
    from mpc_code_tpu_torch.solver.riccati_kernel import riccati_kkt

    ins = _inputs(5, 6, 8, 2, seed=3, bad=1)
    ref = jax.vmap(functools.partial(_riccati_ref, nxa=8, nu=2))(
        *[jnp.asarray(a) for a in ins])
    got = riccati_kkt(*[torch.tensor(a) for a in ins], nxa=8, nu=2)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


@pytest.mark.parametrize("i,name", [(0, "ok"), (1, "Ks"), (2, "kf"), (3, "P_seq"),
                                    (4, "p_seq"), (5, "dX"), (6, "dU")])
def test_plain_matches_jax_at_quadruple_tank_width(wide, i, name):
    ref, got = wide
    ok = ref[0]
    assert not ok[1] and ok.sum() == 4
    if i == 0:
        np.testing.assert_array_equal(got[0], ok)
        return
    assert got[i].shape == ref[i].shape, name
    err = np.abs(got[i][ok] - ref[i][ok]) / (1 + np.abs(ref[i][ok]))
    assert err.max() <= 1e-10, (name, err.max())


def _card_layout_sweeps(monkeypatch):
    """Make the sweeps return, on CPU tensors, what their kernels' wrappers
    return on the card."""
    from mpc_code_tpu_torch.ops.lane_sweep import LaneSweep
    from mpc_code_tpu_torch.solver.sweep_kernel import StageSweep

    def plane_view(o):
        if o.dim() < 3:
            return o
        L = o.shape[0] * o.shape[1]
        return o.reshape(L, -1).t().contiguous().t().reshape(o.shape)

    def call(self, *args):
        outs = self.plain(*args)
        if self.in_place or isinstance(self, StageSweep):
            return tuple(o.contiguous() for o in outs)
        return tuple(map(plane_view, outs))

    monkeypatch.setattr(LaneSweep, "__call__", call)


def _spy_riccati(monkeypatch):
    from mpc_code_tpu_torch.solver import riccati
    from mpc_code_tpu_torch.solver import riccati_kernel as rk

    calls = []

    def spy(*args, nxa, nu):
        # everything but the device is what the kernel takes
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            rk.check_inputs(*args, nxa=nxa, nu=nu)
        calls.append(args[0].shape)
        return rk.riccati_ref(*args, nxa=nxa, nu=nu)

    monkeypatch.setattr(riccati, "riccati_kkt", spy)
    return calls


def _solve_cstr(hessian):
    from mpc_code_tpu_torch.examples import bench_workload as bw

    cfg, model, _, solve = bw.make_problem("cpu", Nh=4, Mx=2, hessian=hessian)
    x0 = bw.draw_x0(3, "cpu", dtype=torch.float64)
    X0, U0 = bw.warm_start(cfg, model, x0, torch.tensor(bw.U_SS).expand(3, 2), 4)
    solve(bw.bench_params(cfg, x0, 4), X0, U0, max_iter=1)


def _solve_controller(module):
    prob = module.make_problem("cpu", Nh=4)
    lanes = module.draw_lanes(3, "cpu", dtype=torch.float64)
    cfg = prob.cfg
    xs = torch.as_tensor(np.asarray(cfg.x0_m, float)).expand(3, cfg.nx)
    us = torch.as_tensor(np.asarray(cfg.u0, float)).expand(3, cfg.nu)
    module.solve_ocps(prob, lanes, xs, us)


def _enmpc():
    from mpc_code_tpu_torch.examples import enmpc_workload

    _solve_controller(enmpc_workload)


def _nmpc_dis():
    from mpc_code_tpu_torch.examples import nmpc_dis_workload

    _solve_controller(nmpc_dis_workload)


def _solve_linear(name, hessian):
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu_torch.solver.riccati import build_structured_ocp, make_structured_solver

    mod = __import__(f"mpc_code_tpu_torch.examples.{name}", fromlist=["make_config"])
    cfg = mod.make_config().replace(N=4)
    s = build_structured_ocp(cfg, build_model(cfg), build_stage_cost(cfg.stage_cost),
                             build_terminal_cost(cfg), device="cpu")
    x0m, u0 = torch.as_tensor(np.asarray(cfg.x0_m, float)), torch.as_tensor(cfg.u0)
    p = dict(x0=x0m.expand(3, cfg.nx), xs=x0m, us=u0, d=torch.zeros(cfg.nd), um1=u0,
             t=0.0, lam=torch.zeros(cfg.ny, cfg.nu), px=torch.zeros(4, cfg.npx),
             py=torch.zeros(4, cfg.npy))
    X0 = torch.cat([x0m, u0])[: s.nxa].expand(3, 5, s.nxa)
    make_structured_solver(s, SolverOptions(hessian=hessian))(
        p, X0, u0.expand(3, 4, cfg.nu), max_iter=1)


@pytest.mark.parametrize("path", ["cstr", "cstr_exact", "enmpc", "nmpc_dis",
                                  "lmpc_nlplant", "lmpc_nlplant_exact", "lmpc_cstr"])
def test_solver_hands_the_kernel_contiguous_tensors(path, monkeypatch):
    _card_layout_sweeps(monkeypatch)
    calls = _spy_riccati(monkeypatch)
    run = {"cstr": lambda: _solve_cstr("gauss_newton"),
           "cstr_exact": lambda: _solve_cstr("exact"),
           "enmpc": _enmpc, "nmpc_dis": _nmpc_dis,
           "lmpc_nlplant": lambda: _solve_linear("lmpc_nlplant", "gauss_newton"),
           "lmpc_nlplant_exact": lambda: _solve_linear("lmpc_nlplant", "exact"),
           "lmpc_cstr": lambda: _solve_linear("lmpc_cstr", "gauss_newton")}[path]
    run()
    assert calls, "the solver never called riccati_kkt"
