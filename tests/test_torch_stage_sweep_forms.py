"""Kernel 5's lowerings of the discrete map, ContForm and the u_prev
augmentation (the fused stage sweep's plain version) against the JAX
package, CPU, f64.

Three OCPs under both Hessians, N=4, B=5 scenarios with non-zero dynamics
and row multipliers, px, py and output-correction matrix:

- nmpc_dis: ``examples/nmpc_dis.py`` (the discrete tank map, its RK4 cut
  from 5 sub-steps to 2, the u_prev augmentation for the Delta-u rows and
  cost: nxa=8, ni=4), scenario 1 with level 1 exactly on the map's clip
  bound 20 (F1's tie, inside the traced map);
- enmpc: ``examples/enmpc.py`` (ContForm, Mx=2; no rows and no guard, so
  no tie);
- cstr_du: the bench's CSTR (Mx=2, its guard) with ``DUForm=True``
  (nxa=5), scenario 1 with its third state on the guard's lower bound.

- ``make_stage_sweep(ps, hessian)`` on CPU tensors against JAX's
  ``vmap(make_stage_derivs(js, hessian))``, both Hessians jitted in one
  call per form in a module fixture: all seven outputs to 1e-10.
- The newly lowered programs (``Program.execute``) against the torch
  functions by ``torch.func``: the discrete map at order 2, and the cost
  and rows that read the u_prev slots (both values of the stage-0 flag):
  value, gradient and Hessian to 1e-12.
- Exact pins of the kernel's operation count at each form's full width
  (its path's OCP in ``chip_smoke.py``).
- ``build_structured_ocp`` gives these OCPs a lowering, and the solver's
  exact route takes the fused stage sweep (and its Gauss-Newton default
  the split sweep).

The whole solve of these OCPs against JAX is
``tests/test_torch_exact_generic.py``'s.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

N, B, MX = 4, 5, 2
TIE_LANE = 1
FORMS = ("nmpc_dis", "enmpc", "cstr_du")
CLIP_LO = np.array([0.0, 280.0, 0.4], np.float32)
CLIP_HI = np.array([2.0, 420.0, 1.0], np.float32)
NAMES = ("H", "gc", "A", "B", "E", "ival", "dval")
HESSIANS = ("exact", "gauss_newton")


def _tank_map(ex, lib):
    """The example's model map with its RK4 cut to MX sub-steps."""
    cat = jnp.concatenate if lib is jnp else torch.cat

    def Fx(x, u, d, t, px):
        return cat([u, ex._rk4_tanks(x[2:6], u, Mx=MX)])

    return Fx


def _cfgs(form):
    """(JAX config, port config) of a form at N."""
    from mpc_code_tpu_torch.convert import config_from_numpy

    if form == "nmpc_dis":
        import mpc_code_tpu.examples.nmpc_dis as jex
        import mpc_code_tpu_torch.examples.nmpc_dis as pex

        jcfg, pcfg = jex.make_config().replace(N=N), pex.make_config().replace(N=N)
        return (jcfg.replace(model=dc.replace(jcfg.model, Fx=_tank_map(jex, jnp))),
                pcfg.replace(model=dc.replace(pcfg.model, Fx=_tank_map(pex, torch))))
    if form == "enmpc":
        from mpc_code_tpu.examples.enmpc import make_config as make_jax
        from mpc_code_tpu_torch.examples.enmpc import make_config as make_port

        jcfg = make_jax().replace(N=N)
        jcfg = jcfg.replace(model=dc.replace(jcfg.model, Mx=MX))
        return jcfg, config_from_numpy(jcfg, make_port())
    from mpc_code_tpu.examples.nmpc import make_config as make_jax
    from mpc_code_tpu_torch.examples.nmpc import make_config as make_port

    jcfg = make_jax().replace(N=N, R_wn=None, DUForm=True)
    jcfg = jcfg.replace(model=dc.replace(jcfg.model, Mx=MX, clip_lo=CLIP_LO,
                                         clip_hi=CLIP_HI))
    return jcfg, config_from_numpy(jcfg, make_port().replace(N=N, R_wn=None))


def _port_ocp(pcfg):
    from mpc_code_tpu_torch.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu_torch.solver.riccati import build_structured_ocp

    return build_structured_ocp(pcfg, build_model(pcfg), build_stage_cost(pcfg.stage_cost),
                                build_terminal_cost(pcfg), device="cpu")


def _inputs(form, ps, cfg):
    """The port's sweep inputs (numpy), seed 0: states and inputs in their
    boxes (scaled), the u_prev slots as inputs."""
    rng = np.random.default_rng(0)
    nx, nu = cfg.nx, cfg.nu
    if form == "nmpc_dis":
        x = np.concatenate([rng.uniform(30.0, 50.0, (B, N, 2)), rng.uniform(6.0, 14.0, (B, N, 2)),
                            rng.uniform(0.5, 3.0, (B, N, 2))], -1)
        x[TIE_LANE, :, 2] = 20.0
        u = rng.uniform(30.0, 50.0, (B, N, nu))
        xs = rng.uniform(5.0, 15.0, (B, nx))
    elif form == "enmpc":
        x, u = rng.uniform(0.0, 1.0, (B, N, nx)), rng.uniform(0.0, 2.0, (B, N, nu))
        xs = rng.uniform([0.4, 0.4], [0.6, 0.5], (B, nx))
    else:
        x = np.concatenate([rng.uniform(0.3, 0.95, (B, N, 1)),
                            rng.uniform(318.0, 340.0, (B, N, 1)),
                            rng.uniform(0.55, 0.7, (B, N, 1))], -1)
        x[TIE_LANE, :, 2] = float(CLIP_LO[2])
        u = np.concatenate([rng.uniform(295.0, 305.0, (B, N, 1)),
                            rng.uniform(0.0, 0.25, (B, N, 1))], -1)
        xs = np.array([0.874317, 325.0, 0.6528]) + rng.normal(0.0, 0.01, (B, 3))
    us = u[:, 0] * (1 + 0.01 * rng.normal(size=(B, nu)))
    if ps.nxa > nx:                          # u_prev: an input near u
        x = np.concatenate([x, u * (1 + 0.05 * rng.normal(size=u.shape))], -1)
    return dict(
        X=x / ps.sxa, U=u / ps.su, lam=rng.normal(0.0, 1.0, (B, N, ps.nxa)),
        nus=rng.normal(0.0, 0.1, (B, N, ps.ni)),
        px=rng.normal(0.0, 0.01, (B, N, cfg.npx)), py=rng.normal(0.0, 0.01, (B, N, cfg.npy)),
        t=rng.uniform(0.0, 1.0, B), sf=rng.uniform(0.5, 1.0, B), xs=xs, us=us,
        d=rng.normal(0.0, 0.05, (B, cfg.nd)), um1=us * (1 + 0.05 * rng.normal(size=(B, nu))),
        lamy=rng.normal(0.0, 0.01, (B, cfg.ny * nu)))


def _jax_derivs(js, jcfg, a):
    """JAX's vmapped make_stage_derivs at the inputs under each Hessian, in
    one jitted call: the seven outputs (without Cz, hval) by Hessian."""
    from mpc_code_tpu.solver.riccati import make_stage_derivs

    p = {k: jnp.asarray(a[k]) for k in ("xs", "us", "d", "um1", "t", "px", "py")}
    p["lam"] = jnp.asarray(a["lamy"].reshape(B, jcfg.ny, jcfg.nu))
    p["_sf"] = jnp.asarray(a["sf"])
    p["x0"] = jnp.asarray(a["X"][:, 0, :jcfg.nx])
    ks = jnp.arange(N)
    v_stage = {h: jax.vmap(make_stage_derivs(js, h), in_axes=(0, 0, 0, None, 0, 0, 0))
               for h in HESSIANS}

    def ref(X, U, pp, lam, nus, muh):
        return {h: v(X, U, ks, pp, lam, nus, muh) for h, v in v_stage.items()}

    out = jax.device_get(jax.jit(jax.vmap(ref))(
        jnp.asarray(a["X"]), jnp.asarray(a["U"]), p, jnp.asarray(a["lam"]),
        jnp.asarray(a["nus"]), jnp.zeros((B, N, 0))))
    return {h: [np.asarray(o[i]) for i in (0, 1, 2, 3, 4, 5, 8)] for h, o in out.items()}


@pytest.fixture(scope="module")
def forms():
    """Per form: the port's OCP, its config, the inputs, and per Hessian
    JAX's outputs and the port's plain sweep's."""
    from mpc_code_tpu.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu.solver.riccati import build_structured_ocp
    from mpc_code_tpu_torch.solver.sweep_kernel import make_stage_sweep

    out = {}
    for form in FORMS:
        jcfg, pcfg = _cfgs(form)
        js = build_structured_ocp(jcfg, build_model(jcfg), build_stage_cost(jcfg.stage_cost),
                                  build_terminal_cost(jcfg))
        ps = _port_ocp(pcfg)
        a = _inputs(form, ps, pcfg)
        T = {k: torch.tensor(v) for k, v in a.items()}
        ref, res = _jax_derivs(js, jcfg, a), {}
        for hess in HESSIANS:
            got = make_stage_sweep(ps, hess)(
                T["X"], T["U"], T["lam"], T["nus"], T["px"], T["py"],
                torch.zeros(T["X"].shape[:2] + (0,), dtype=torch.float64), T["t"], T["sf"],
                T["xs"], T["us"], T["d"], T["um1"], T["lamy"])
            res[hess] = (ref[hess], [g.numpy() for g in got])
        out[form] = dict(ps=ps, cfg=pcfg, a=a, res=res)
    return out


def _nerr(a, b):
    return float((np.abs(a - b) / (1 + np.abs(b))).max()) if b.size else 0.0


@pytest.mark.parametrize("hessian", ["exact", "gauss_newton"])
@pytest.mark.parametrize("form", FORMS)
def test_plain_sweep_matches_jax(forms, form, hessian):
    ref, got = forms[form]["res"][hessian]
    for name, r, g in zip(NAMES, ref, got):
        assert g.shape == r.shape, (name, g.shape, r.shape)
        assert np.isfinite(g).all(), name
        assert _nerr(g, r) <= 1e-10, (name, _nerr(g, r))
        if form != "enmpc":
            assert _nerr(g[TIE_LANE], r[TIE_LANE]) <= 1e-10, name
    H = got[0]
    assert np.abs(H - np.swapaxes(H, -1, -2)).max() <= 1e-10 * (1 + np.abs(H).max())


@pytest.mark.parametrize("form", FORMS)
def test_u_prev_rows_and_the_exact_terms(forms, form):
    """The u_prev rows are u over the slots' scales with A's rows and
    columns zero and B's identity block scaled by su / sxa; the exact and
    the Gauss-Newton H differ by the multipliers' curvature terms."""
    f = forms[form]
    ps, a = f["ps"], f["a"]
    ex, gn = f["res"]["exact"][1], f["res"]["gauss_newton"][1]
    assert np.abs(ex[0] - gn[0]).max() > 1e-6
    for name, x, y in zip(NAMES[1:], ex[1:], gn[1:]):
        np.testing.assert_array_equal(x, y, err_msg=name)
    nx, nxa, nu = f["cfg"].nx, ps.nxa, ps.nu
    if nxa == nx:
        return
    H, _, A, Bm, _, _, dval = ex[:7]
    np.testing.assert_allclose(dval[..., nx:], a["U"] * ps.su / ps.sxa[nx:], rtol=1e-15)
    assert not A[..., nx:, :].any() and not A[..., :, nx:].any()
    np.testing.assert_allclose(Bm[..., nx:, :], np.broadcast_to(
        np.diag(ps.su / ps.sxa[nx:]), Bm[..., nx:, :].shape), rtol=1e-15)
    # the stage-0 Delta-u reads the parameter: H has no u_prev entries there
    assert not H[:, 0, nx:nxa, :].any()


def _point(form, ps, cfg, k0):
    """One point's inputs of the lowered cost and rows (user units): lane
    TIE_LANE, stage 0 (k0) or 2."""
    a = _inputs(form, ps, cfg)
    st = 0 if k0 else 2
    T = lambda v: torch.tensor(np.asarray(v, float))  # noqa: E731
    xa = T(a["X"][TIE_LANE, st] * ps.sxa)
    u = T(a["U"][TIE_LANE, st] * ps.su)
    rest = dict(t=T(a["t"][TIE_LANE]), xs=T(a["xs"][TIE_LANE]), us=T(a["us"][TIE_LANE]),
                d=T(a["d"][TIE_LANE]), um1=T(a["um1"][TIE_LANE]), lam=T(a["lamy"][TIE_LANE]),
                py=T(a["py"][TIE_LANE, st]), py0=T(a["py"][TIE_LANE, 0]),
                k0=torch.tensor(k0))
    return xa, u, rest, T(a["px"][TIE_LANE, st])


def _close(f_lowered, f_direct, z):
    assert torch.allclose(f_lowered(z), f_direct(z), rtol=1e-14, atol=0)
    for d in (torch.func.jacrev, torch.func.hessian):
        assert torch.allclose(d(f_lowered)(z), d(f_direct)(z), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("k0", [False, True])
@pytest.mark.parametrize("which,form", [("cost", "nmpc_dis"), ("ineq", "nmpc_dis"),
                                        ("cost", "cstr_du"), ("ineq", "cstr_du")])
def test_lowered_u_prev_stage_functions_match_torch(which, form, k0):
    """The generated statements of the stage cost and the rows on z =
    (xa, u) with xa = (x, u_prev), run in Python, against the torch
    functions: value, gradient and Hessian."""
    from mpc_code_tpu_torch.solver.sweep_kernel import stage_programs

    _, pcfg = _cfgs(form)
    ps = _port_ocp(pcfg)
    low = ps.lowering
    assert low.nup == pcfg.nu and low.point_args[-1] == "k0"
    prog = getattr(stage_programs(low, ps.nxa, ps.nu, ps.ni, pcfg.nd, pcfg.npx, pcfg.npy),
                   which)
    fn = getattr(low, which)
    xa, u, rest, _ = _point(form, ps, pcfg, k0)
    nxa = ps.nxa
    mat = dict(rest, lam=rest["lam"].reshape(pcfg.ny, pcfg.nu))

    def lowered(z):
        return torch.stack(prog.execute(xa=z[:nxa], u=z[nxa:], **rest)).reshape(-1)

    def direct(z):
        return fn(z[:nxa], z[nxa:], *[mat[k] for k in low.point_args]).reshape(-1)

    _close(lowered, direct, torch.cat([xa, u]))
    assert prog.ops > 0


def test_lowered_map_at_order_two_matches_torch():
    """The tank map lowered at order 2, run in Python, against the torch
    map on a point with level 1 on the clip bound: value, Jacobian and
    Hessian with respect to (x, u)."""
    from mpc_code_tpu_torch.ops.sweep_map_cuda import map_program

    _, pcfg = _cfgs("nmpc_dis")
    ps = _port_ocp(pcfg)
    low = ps.lowering
    assert low.kind == "map" and low.fmap is pcfg.model.Fx
    nx, nu = pcfg.nx, pcfg.nu
    prog = map_program(low.fmap, nx, nu, pcfg.nd, pcfg.npx, order=2)
    assert prog.np2 == (nx + nu) * (nx + nu + 1) // 2
    xa, u, rest, px = _point("nmpc_dis", ps, pcfg, False)
    d, t = rest["d"], rest["t"]

    def lowered(z):
        return torch.stack(prog.execute(x=z[:nx], u=z[nx:], d=d, t=t, px=px))

    def direct(z):
        return low.fmap(z[:nx], z[nx:], d, t, px)

    _close(lowered, direct, torch.cat([xa[:nx], u]))


def _full_width(form):
    """The form's path's OCP in ``chip_smoke.py``, at full width."""
    if form == "cstr_du":
        from mpc_code_tpu_torch.examples.bench_workload import make_problem

        cfg, _, s, _ = make_problem("cpu", hessian="exact", DUForm=True)
        return cfg, s
    if form == "nmpc_dis":
        from mpc_code_tpu_torch.examples.nmpc_dis_workload import make_problem
    else:
        from mpc_code_tpu_torch.examples.enmpc_workload import make_problem
    prob = make_problem("cpu")
    return prob.cfg, prob.socp


@pytest.mark.parametrize("form,dims,ops", [
    ("nmpc_dis", (8, 2, 4, 2, 6, 2), (54109, 14477)),
    ("enmpc", (2, 1, 0, 2, 2, 2), (11960, 11936)),
    ("cstr_du", (5, 2, 2, 2, 3, 2), (46647, 11470))])
def test_ops_per_lane_pinned_at_full_width(form, dims, ops):
    """What the generator emits for each form at its path's width, exact
    and Gauss-Newton: the count behind each build's bound.  The step runs
    on the state's and the input's tangents alone (the u_prev slots do not
    enter it); ContForm's step keeps its second order under Gauss-Newton,
    as its quadrature is the cost."""
    from mpc_code_tpu_torch.solver.sweep_kernel import make_stage_sweep

    cfg, s = _full_width(form)
    assert (s.nxa, s.nu, s.ni, cfg.nd, cfg.npx, cfg.npy) == dims
    assert tuple(make_stage_sweep(s, h).ops_per_lane(*dims)
                 for h in ("exact", "gauss_newton")) == ops


@pytest.mark.parametrize("form", FORMS)
def test_the_exact_route_takes_the_fused_sweep(forms, form, monkeypatch):
    """The OCP has a lowering of its kind; the solver built for the exact
    Hessian makes the fused stage sweep and calls it once a pass, while
    Gauss-Newton keeps its split sweep (kernel 3, 4 or 1)."""
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.solver import sweep_kernel as sk
    from mpc_code_tpu_torch.solver.riccati import make_structured_solver

    f = forms[form]
    ps, a = f["ps"], f["a"]
    assert ps.lowering.kind == {"nmpc_dis": "map", "enmpc": "cf", "cstr_du": "rk4"}[form]
    assert ps.lowering.nup == (0 if form == "enmpc" else f["cfg"].nu)
    calls = []
    real = sk.make_stage_sweep

    def counting(s, hessian="exact"):
        sweep = real(s, hessian)
        plain = sweep.plain

        def counted(*args):
            calls.append(hessian)
            return plain(*args)
        sweep.plain = counted
        return sweep

    monkeypatch.setattr(sk, "make_stage_sweep", counting)
    make_structured_solver(ps, SolverOptions(hessian="gauss_newton"))
    assert calls == []
    solve = make_structured_solver(ps, SolverOptions(hessian="exact", max_iter=2))
    par = dict(x0=a["X"][:2, 0, :f["cfg"].nx] * ps.sxa[:f["cfg"].nx], xs=a["xs"][:2],
               us=a["us"][:2], d=a["d"][:2], um1=a["um1"][:2], t=a["t"][:2],
               lam=a["lamy"][0].reshape(f["cfg"].ny, f["cfg"].nu), px=a["px"][0],
               py=a["py"][0])
    r = solve(par, torch.tensor(np.concatenate([a["X"][:2], a["X"][:2, -1:]], 1) * ps.sxa),
              torch.tensor(a["U"][:2] * ps.su))
    assert calls and set(calls) == {"exact"} and int(r.iters.max()) >= 1
