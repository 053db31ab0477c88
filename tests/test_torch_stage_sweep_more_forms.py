"""Kernel 5's lowerings of a LinearModel, the shared slacks, the user rows
(G_ineq, H_eq) and collocation (the fused stage sweep's plain version)
against the JAX package, CPU, f64.

Four OCPs under both Hessians, N=4, B=5 scenarios with non-zero dynamics,
row and equality multipliers (lam, nus, mu_h), px, py and
output-correction matrix:

- lin: ``examples/lmpc_nlplant.py`` (the affine model lowered as a map,
  DUForm: nxa=5, the u_prev slots);
- lp: the same model under the LP stage cost r_x|dx| + r_Du|du|
  (``torch.abs``, lowered as max(a, -a)), scenario 1 with its first state
  on its target and its first input on its u_prev slot at stage 2 (the
  tie of |.| at 0);
- slacks: the bench's CSTR (Mx=2, its guard) with the shared output
  slacks extended over one G_ineq and one H_eq row (``slacksG``,
  ``slacksH``: ns=6, nxa=9), scenario 1 with its third state on the
  guard's lower bound (F1's tie);
- rows: the CSTR with TermCons, ``tests/test_riccati.py:425-430``'s H_eq
  line and one G_ineq row (the tie as above);
- colloc: the CSTR with ``Collocation=True`` and ``n_colloc_newton=2`` in
  both packages (two Newton steps leave a residual, so the differentiable
  step's curvature terms count).

Checks:
- ``make_stage_sweep(ps, hessian)`` on CPU tensors against JAX's
  ``vmap(make_stage_derivs(js, hessian))``, both Hessians jitted in one
  call per form in a module fixture: all nine outputs (H, gc, A, B, E,
  ival, dval, Cz, hval) to 1e-10;
- the newly lowered programs (``Program.execute``) against the torch
  functions by ``torch.func``: the slack penalty, the slack-relaxed rows,
  the equality rows (both values of the stage-0 flag where the form reads
  it) and the collocated cost and rows, whose stage states come from the
  torch Newton solve: value, gradient and Hessian to 1e-12;
- the code generator on ``.sum()``, ``reshape(-1)`` and ``atleast_1d``;
- the route: a LinearModel and a collocated OCP take the fused sweep
  under both Hessians, the slack and user-row forms under the exact one,
  and under Gauss-Newton the CSTR with slacks or H_eq keeps its split
  sweep (kernel 1);
- exact pins of the kernel's operation count at each path's full width
  (its OCP in ``chip_smoke.py``).
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

N, B, MX = 4, 5, 2
NEWTON = 2
TIE_LANE = 1
FORMS = ("lin", "lp", "slacks", "rows", "colloc")
LP_RX = np.array([[1.0, 0.01, 1.0]])
LP_RDU = np.array([[0.1, 10.0]])
CLIP_LO = np.array([0.0, 280.0, 0.4], np.float32)
CLIP_HI = np.array([2.0, 420.0, 1.0], np.float32)
NAMES = ("H", "gc", "A", "B", "E", "ival", "dval", "Cz", "hval")
JAX_ORDER = (0, 1, 2, 3, 4, 5, 8, 6, 7)      # make_stage_derivs' outputs, as NAMES
HESSIANS = ("exact", "gauss_newton")


def _heq(lib):
    def H_eq(x, u, y, d, t, px, py):
        return lib.atleast_1d(u[0] + 50.0 * u[1] - 305.157 - 0.1 * (x[1] - 325.0))
    return H_eq


def _gin(lib):
    def G_ineq(x, u, y, d, t, px, py):
        return lib.atleast_1d(297.5 - u[0] + 0.05 * (x[1] - 325.0) + 10.0 * px[0])
    return G_ineq


def _coll_cost(lib):
    """The bench's collocation cost (``examples/bench_workload.py``) with a
    term in the stage states S (dS = S - (xs, xs) under QForm), so that
    the cost reads S's second-order tangents."""
    if lib is jnp:
        from mpc_code_tpu.config import StageCost
        from mpc_code_tpu.models.costs import xQx
    else:
        from mpc_code_tpu_torch.config import StageCost
        from mpc_code_tpu_torch.models.costs import xQx
    Q, R = np.diag([1.0, 1e-4, 1.0]), np.diag([1e-4, 1.0])
    Qs = np.diag([1.0, 1e-4, 1.0, 1.0, 1e-4, 1.0])

    def f_coll(x, u, y, xs, us, ys, s):
        return 0.5 * (xQx(x, Q) + xQx(u, R)) + 0.1 * xQx(s, Qs)
    return StageCost(f_coll=f_coll)


def _cfgs(form):
    """(JAX config, port config) of a form at N."""
    from mpc_code_tpu_torch.convert import config_from_numpy

    if form in ("lin", "lp"):
        import mpc_code_tpu.examples.lmpc_nlplant as jex
        import mpc_code_tpu_torch.examples.lmpc_nlplant as pex

        jcfg, pcfg = jex.make_config(Nsim=5).replace(N=N), pex.make_config(Nsim=5)
        if form == "lp":
            from mpc_code_tpu.config import StageCost as JStageCost
            from mpc_code_tpu_torch.config import StageCost as PStageCost

            # no Riccati terminal weight: it needs the QP weights
            jcfg = jcfg.replace(stage_cost=JStageCost(r_x=LP_RX, r_Du=LP_RDU),
                                terminal=dc.replace(jcfg.terminal, riccati=False))
            pcfg = pcfg.replace(stage_cost=PStageCost(r_x=LP_RX, r_Du=LP_RDU),
                                terminal=dc.replace(pcfg.terminal, riccati=False))
        return jcfg, config_from_numpy(jcfg, pcfg)
    from mpc_code_tpu.examples.nmpc import make_config as make_jax
    from mpc_code_tpu_torch.examples.nmpc import make_config as make_port

    def rows(lib):
        if form == "slacks":
            return dict(slacks=True, slacksG=True, slacksH=True, Ws=10.0 * np.eye(6),
                        G_ineq=_gin(lib), H_eq=_heq(lib))
        if form == "rows":
            return dict(TermCons=True, G_ineq=_gin(lib), H_eq=_heq(lib))
        return dict(Collocation=True, stage_cost=_coll_cost(lib))

    jcfg = make_jax().replace(N=N, R_wn=None, **rows(jnp))
    jcfg = jcfg.replace(model=dc.replace(jcfg.model, Mx=MX, clip_lo=CLIP_LO,
                                         clip_hi=CLIP_HI))
    return jcfg, config_from_numpy(jcfg, make_port().replace(N=N, R_wn=None, **rows(torch)))


def _port_ocp(pcfg, n_newton=NEWTON):
    from mpc_code_tpu_torch.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu_torch.solver.riccati import build_structured_ocp

    return build_structured_ocp(pcfg, build_model(pcfg), build_stage_cost(pcfg.stage_cost),
                                build_terminal_cost(pcfg), device="cpu",
                                n_colloc_newton=n_newton)


def _inputs(form, ps, cfg):
    """The port's sweep inputs (numpy), seed 0: states and inputs near the
    example's operating point (scaled), the u_prev and slack slots as
    inputs, multipliers of the size the solves meet."""
    rng = np.random.default_rng(0)
    nx, nuc = cfg.nx, ps.nu_ctrl
    if form in ("lin", "lp"):
        x0, u0 = np.asarray(cfg.x0_m, float), np.asarray(cfg.u0, float)
        x = x0 * (1 + 0.05 * rng.normal(size=(B, N, nx)))
        u = u0 * (1 + 0.05 * rng.normal(size=(B, N, nuc)))
        xs = x0 * (1 + 0.01 * rng.normal(size=(B, nx)))
    else:
        x = np.concatenate([rng.uniform(0.3, 0.95, (B, N, 1)),
                            rng.uniform(318.0, 340.0, (B, N, 1)),
                            rng.uniform(0.55, 0.7, (B, N, 1))], -1)
        x[TIE_LANE, :, 2] = float(CLIP_LO[2])
        u = np.concatenate([rng.uniform(295.0, 305.0, (B, N, 1)),
                            rng.uniform(0.0, 0.25, (B, N, 1))], -1)
        xs = np.array([0.874317, 325.0, 0.6528]) + rng.normal(0.0, 0.01, (B, 3))
    us = u[:, 0] * (1 + 0.01 * rng.normal(size=(B, nuc)))
    if ps.lowering.nup:
        x = np.concatenate([x, u * (1 + 0.05 * rng.normal(size=u.shape))], -1)
    if ps.ns:
        x = np.concatenate([x, rng.uniform(0.0, 0.3, (B, N, ps.ns))], -1)
        u = np.concatenate([u, rng.uniform(0.0, 0.3, (B, N, ps.ns))], -1)
    X, U = x / ps.sxa, u / ps.su
    if form == "lp":
        # exact ties in the working units: x = X sxa on its target, the
        # u_prev slot (of unit scale) on the input U su; X and U on a grid
        # of 2^-30, so that the products are exact, fused or not
        assert ps.sxa[nx] == 1.0
        for v in (X[TIE_LANE, 2, :1], U[TIE_LANE, 2, :1]):
            v[:] = np.round(v * 2.0**30) / 2.0**30
        xs[TIE_LANE, 0] = X[TIE_LANE, 2, 0] * ps.sxa[0]
        X[TIE_LANE, 2, nx] = U[TIE_LANE, 2, 0] * ps.su[0]
    return dict(
        X=X, U=U, lam=rng.normal(0.0, 1.0, (B, N, ps.nxa)),
        nus=rng.normal(0.0, 0.1, (B, N, ps.ni)),
        px=rng.normal(0.0, 0.01, (B, N, cfg.npx)), py=rng.normal(0.0, 0.01, (B, N, cfg.npy)),
        t=rng.uniform(0.0, 1.0, B), sf=rng.uniform(0.5, 1.0, B), xs=xs, us=us,
        d=rng.normal(0.0, 0.05, (B, cfg.nd)), um1=us * (1 + 0.05 * rng.normal(size=(B, nuc))),
        lamy=rng.normal(0.0, 0.01, (B, cfg.ny * nuc)),
        mu_h=rng.normal(0.0, 1.0, (B, N, ps.n_eq)))


def _jax_derivs(js, jcfg, a):
    """JAX's vmapped make_stage_derivs at the inputs under each Hessian, in
    one jitted call: the nine outputs in NAMES' order, by Hessian."""
    from mpc_code_tpu.solver.riccati import make_stage_derivs

    p = {k: jnp.asarray(a[k]) for k in ("xs", "us", "d", "um1", "t", "px", "py")}
    p["lam"] = jnp.asarray(a["lamy"].reshape(B, jcfg.ny, -1))
    p["_sf"] = jnp.asarray(a["sf"])
    p["x0"] = jnp.asarray(a["X"][:, 0, :jcfg.nx])
    ks = jnp.arange(N)
    v_stage = {h: jax.vmap(make_stage_derivs(js, h), in_axes=(0, 0, 0, None, 0, 0, 0))
               for h in HESSIANS}

    def ref(X, U, pp, lam, nus, muh):
        return {h: v(X, U, ks, pp, lam, nus, muh) for h, v in v_stage.items()}

    out = jax.device_get(jax.jit(jax.vmap(ref))(
        jnp.asarray(a["X"]), jnp.asarray(a["U"]), p, jnp.asarray(a["lam"]),
        jnp.asarray(a["nus"]), jnp.asarray(a["mu_h"])))
    return {h: [np.asarray(o[i]) for i in JAX_ORDER] for h, o in out.items()}


def _sweep_args(a):
    T = {k: torch.tensor(v) for k, v in a.items()}
    return tuple(T[k] for k in ("X", "U", "lam", "nus", "px", "py", "mu_h", "t", "sf", "xs",
                                "us", "d", "um1", "lamy"))


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
                                  build_terminal_cost(jcfg), n_colloc_newton=NEWTON)
        ps = _port_ocp(pcfg)
        a = _inputs(form, ps, pcfg)
        ref, res = _jax_derivs(js, jcfg, a), {}
        for hess in HESSIANS:
            got = make_stage_sweep(ps, hess)(*_sweep_args(a))
            res[hess] = (ref[hess], [g.numpy() for g in got])
        out[form] = dict(ps=ps, js=js, cfg=pcfg, a=a, res=res)
    return out


def _nerr(a, b):
    return float((np.abs(a - b) / (1 + np.abs(b))).max()) if b.size else 0.0


@pytest.mark.parametrize("hessian", HESSIANS)
@pytest.mark.parametrize("form", FORMS)
def test_plain_sweep_matches_jax(forms, form, hessian):
    f = forms[form]
    ps, js = f["ps"], f["js"]
    assert (ps.nxa, ps.nu, ps.ni, ps.ns, ps.n_eq) == (js.nxa, js.nu, js.ni, js.ns, js.n_eq)
    ref, got = f["res"][hessian]
    # nine outputs; without stage equalities Cz and hval are empty, as JAX's
    assert len(got) == 9
    for name, r, g in zip(NAMES, ref, got):
        assert g.shape == r.shape, (name, g.shape, r.shape)
        assert np.isfinite(g).all(), name
        assert _nerr(g, r) <= 1e-10, (name, _nerr(g, r))
        if form in ("lp", "slacks", "rows"):
            assert _nerr(g[TIE_LANE], r[TIE_LANE]) <= 1e-10, name
    H = got[0]
    assert np.abs(H - np.swapaxes(H, -1, -2)).max() <= 1e-10 * (1 + np.abs(H).max())


def test_slack_rows_of_the_map(forms):
    """The slack slots of dval, A and B: the input slots at stage 0 (B's
    identity block), the carried state slots after it (A's), zeros
    elsewhere in those rows; the slacks' curvature is the cost's alone."""
    f = forms["slacks"]
    ps, a = f["ps"], f["a"]
    H, _, A, Bm, _, _, dval, _, _ = f["res"]["exact"][1]
    r0, nuc, ns = ps.nxa - ps.ns, ps.nu_ctrl, ps.ns
    eye = np.eye(ns)
    np.testing.assert_array_equal(dval[:, 0, r0:], a["U"][:, 0, nuc:])
    np.testing.assert_array_equal(dval[:, 1:, r0:], a["X"][:, 1:, r0:])
    np.testing.assert_array_equal(Bm[:, 0, r0:], np.broadcast_to(
        np.concatenate([np.zeros((ns, nuc)), eye], 1), Bm[:, 0, r0:].shape))
    assert not A[:, 0, r0:].any() and not Bm[:, 1:, r0:].any()
    np.testing.assert_array_equal(A[:, 1:, r0:], np.broadcast_to(
        np.concatenate([np.zeros((ns, r0)), eye], 1), A[:, 1:, r0:].shape))
    # the model's rows read neither the slack slots nor the slack inputs
    assert not A[:, :, :r0, r0:].any() and not Bm[:, :, :r0, nuc:].any()


def _point(form, ps, cfg, k0):
    """One point's inputs of the lowered cost and rows (user units): lane
    TIE_LANE, stage 0 (k0) or 2, as the point arguments' dict."""
    a = _inputs(form, ps, cfg)
    st = 0 if k0 else 2
    T = lambda v: torch.tensor(np.asarray(v, float))  # noqa: E731
    xa = T(a["X"][TIE_LANE, st] * ps.sxa)
    u = T(a["U"][TIE_LANE, st] * ps.su)
    rest = dict(t=T(a["t"][TIE_LANE]), xs=T(a["xs"][TIE_LANE]), us=T(a["us"][TIE_LANE]),
                d=T(a["d"][TIE_LANE]), um1=T(a["um1"][TIE_LANE]), lam=T(a["lamy"][TIE_LANE]),
                py=T(a["py"][TIE_LANE, st]), py0=T(a["py"][TIE_LANE, 0]),
                px=T(a["px"][TIE_LANE, st]), k0=torch.tensor(k0))
    return xa, u, rest


def _close(f_lowered, f_direct, z):
    assert torch.allclose(f_lowered(z), f_direct(z), rtol=1e-14, atol=1e-15)
    for d in (torch.func.jacrev, torch.func.hessian):
        assert torch.allclose(d(f_lowered)(z), d(f_direct)(z), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("k0", [False, True])
@pytest.mark.parametrize("which,form", [("cost", "slacks"), ("ineq", "slacks"),
                                        ("eq", "slacks"), ("ineq", "rows"), ("eq", "rows"),
                                        ("cost", "lin"), ("cost", "lp")])
def test_lowered_stage_functions_match_torch(which, form, k0):
    """The generated statements of the stage cost, the inequality rows and
    the equality rows on z = (xa, u), run in Python, against the torch
    functions: value, gradient and Hessian."""
    from mpc_code_tpu_torch.solver.sweep_kernel import eq_program, stage_programs

    _, pcfg = _cfgs(form)
    ps = _port_ocp(pcfg)
    low = ps.lowering
    dims = (ps.nxa, ps.nu, pcfg.nd, pcfg.npx, pcfg.npy)
    prog = (eq_program(low, *dims) if which == "eq" else
            getattr(stage_programs(low, ps.nxa, ps.nu, ps.ni, *dims[2:]), which))
    if form in ("slacks", "lin", "lp"):
        assert low.point_args[-1] == "k0"
    fn = getattr(low, which)
    xa, u, rest = _point(form, ps, pcfg, k0)
    nxa = ps.nxa
    mat = dict(rest, lam=rest["lam"].reshape(pcfg.ny, ps.nu_ctrl))
    args = {k: rest[k] for k in low.point_args}

    def lowered(z):
        return torch.stack(prog.execute(xa=z[:nxa], u=z[nxa:], **args)).reshape(-1)

    def direct(z):
        return fn(z[:nxa], z[nxa:], *[mat[k] for k in low.point_args]).reshape(-1)

    _close(lowered, direct, torch.cat([xa, u]))
    assert prog.ops > 0


@pytest.mark.parametrize("which", ["cost", "ineq"])
def test_lowered_collocation_stage_functions_match_torch(which):
    """The collocated cost and rows read the stage states S as the point
    argument ``s_coll``: the generated statements, given S from the torch
    Newton solve (the OCP's own rows, whose tail is S over its scales),
    against the OCP's scaled functions, which solve for S themselves:
    value, gradient and Hessian with respect to z in user units."""
    from mpc_code_tpu_torch.solver.sweep_kernel import stage_programs

    _, pcfg = _cfgs("colloc")
    ps = _port_ocp(pcfg)
    low = ps.lowering
    assert low.kind == "coll" and low.point_args[-1] == "s_coll" and low.n_newton == NEWTON
    nx, nxa = pcfg.nx, ps.nxa
    prog = getattr(stage_programs(low, nxa, ps.nu, ps.ni, pcfg.nd, pcfg.npx, pcfg.npy),
                   which)
    xa, u, rest = _point("colloc", ps, pcfg, False)
    args = {k: rest[k] for k in low.point_args if k != "s_coll"}
    pk = dict(rest, lam=rest["lam"].reshape(pcfg.ny, ps.nu_ctrl),
              px0=rest["px"], _sf=torch.tensor(1.0, dtype=torch.float64))
    sxa, su = torch.tensor(ps.sxa), torch.tensor(ps.su)
    si_S = torch.tensor(ps.si[-2 * nx:])
    scaled = getattr(ps, which)

    def S_of(z):
        return ps.ineq(z[:nxa] / sxa, z[nxa:] / su, pk)[-2 * nx:] * si_S

    def lowered(z):
        return torch.stack(prog.execute(xa=z[:nxa], u=z[nxa:], s_coll=S_of(z),
                                        **args)).reshape(-1)

    def direct(z):
        v = scaled(z[:nxa] / sxa, z[nxa:] / su, pk).reshape(-1)
        return v * torch.tensor(ps.si) if which == "ineq" else v

    _close(lowered, direct, torch.cat([xa, u]))


def test_codegen_sum_reshape_atleast_1d():
    """``.sum()`` of a vector (left to right), ``reshape(-1)`` of a vector
    and ``torch.atleast_1d`` of a scalar, as user rows and the slack
    penalty write them: the statements against the function, derivatives
    included; other shapes raise."""
    from mpc_code_tpu_torch.ops.codegen import Arg, Program

    W = torch.tensor([[2.0, 0.5], [0.5, 3.0]], dtype=torch.float64)

    def f(x, u):
        pen = (u * (W.to(u) @ u)).sum()
        row = torch.atleast_1d(u[0] + 50.0 * u[1] - 0.1 * (x[1] - 325.0))
        return torch.cat([row, (x * u).reshape(-1), torch.atleast_1d(pen), x.sum().reshape(-1)])

    prog = Program(f, (Arg("x", "dual", 2), Arg("u", "dual", 2)), 4, out_dim=5, order=2)
    z = torch.tensor([0.7, 330.0, 300.0, 0.1], dtype=torch.float64)

    def lowered(zz):
        return torch.stack(prog.execute(x=zz[:2], u=zz[2:]))

    def direct(zz):
        return f(zz[:2], zz[2:])

    _close(lowered, direct, z)
    for bad in (lambda x, u: x.reshape(2, 1)[0], lambda x, u: torch.sum(x, 0)):
        with pytest.raises(NotImplementedError):
            Program(bad, (Arg("x", "dual", 2), Arg("u", "dual", 2)), 4, out_dim=1)


def test_codegen_abs_takes_jax_derivative():
    """``torch.abs`` (and ``.abs()``) lowered with JAX's derivative, +1 at
    0 (``torch.abs`` has 0 there): the statements against ``jnp.abs`` by
    ``jax.jacfwd`` and ``jax.hessian``, at a point with a component on 0
    and one on the kink of a shifted argument."""
    from mpc_code_tpu_torch.ops.codegen import Arg, Program

    r = np.array([1.0, 0.5])

    def f(lib, x, u):
        return lib.stack([(lib.asarray(r) @ lib.abs(x)) + lib.abs(u[0] - 300.0) * u[1],
                          lib.abs(x[1] * u[1])])

    def port(x, u):
        return torch.stack([(torch.tensor(r).to(x) @ torch.abs(x)) + (u[0] - 300.0).abs() * u[1],
                            torch.abs(x[1] * u[1])])

    prog = Program(port, (Arg("x", "dual", 2), Arg("u", "dual", 2)), 4, out_dim=2, order=2)
    assert "mpc_where(" in prog.body
    for zv in ([0.0, -1.5, 300.0, 0.25], [0.7, 0.0, 299.0, -0.5], [-0.3, 2.0, 301.0, 0.0]):
        z = torch.tensor(zv, dtype=torch.float64)

        def lowered(zz):
            return torch.stack(prog.execute(x=zz[:2], u=zz[2:]))

        def jf(zz):
            return f(jnp, zz[:2], zz[2:])

        zj = jnp.asarray(zv)
        for mine, ref in ((lowered(z), jf(zj)),
                          (torch.func.jacfwd(lowered)(z), jax.jacfwd(jf)(zj)),
                          (torch.func.hessian(lowered)(z), jax.hessian(jf)(zj))):
            np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-14, atol=1e-15)


def _counting(monkeypatch):
    from mpc_code_tpu_torch.solver import sweep_kernel as sk

    built = []
    real = sk.make_stage_sweep
    monkeypatch.setattr(sk, "make_stage_sweep",
                        lambda s, h="exact": built.append(h) or real(s, h))
    return built


@pytest.mark.parametrize("form", FORMS)
def test_the_route_follows_jax(forms, form, monkeypatch):
    """Kernel 5 wherever JAX's fast sweep is off: a LinearModel and a
    collocated OCP (no split sweep) under both Hessians, the slack and
    user-row forms under the exact Hessian; under Gauss-Newton those keep
    the split sweep (kernel 1 plus torch.func), as JAX keeps its fast
    sweep.  One pass of the exact solver calls the fused sweep."""
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.solver.riccati import make_structured_solver

    ps = forms[form]["ps"]
    split_gn = form in ("slacks", "rows")
    assert (ps.stage_dyn_jac is not None) == split_gn
    assert ps.lowering.kind == {"lin": "map", "lp": "map", "colloc": "coll"}.get(form, "rk4")
    built = _counting(monkeypatch)
    make_structured_solver(ps, SolverOptions(hessian="gauss_newton"))
    assert built == ([] if split_gn else ["gauss_newton"])
    make_structured_solver(ps, SolverOptions(hessian="exact"))
    assert built[-1] == "exact"


def test_exact_solve_calls_the_fused_sweep_with_mu_h(forms, monkeypatch):
    """The rows form's exact solve (TermCons with H_eq, the bordered
    recursion) hands the fused sweep the equality multipliers and takes
    Cz and hval from it, once a pass."""
    from mpc_code_tpu_torch.config import SolverOptions
    from mpc_code_tpu_torch.solver import sweep_kernel as sk
    from mpc_code_tpu_torch.solver.riccati import make_structured_solver

    f = forms["rows"]
    ps, a, cfg = f["ps"], f["a"], f["cfg"]
    calls = []
    real = sk.make_stage_sweep

    def counting(s, hessian="exact"):
        sweep = real(s, hessian)
        plain = sweep.plain

        def counted(*args):
            calls.append(len(args))
            return plain(*args)
        sweep.plain = counted
        return sweep

    monkeypatch.setattr(sk, "make_stage_sweep", counting)
    solve = make_structured_solver(ps, SolverOptions(hessian="exact", max_iter=2))
    nx = cfg.nx
    par = dict(x0=a["X"][:2, 0, :nx] * ps.sxa[:nx], xs=a["xs"][:2], us=a["us"][:2],
               d=a["d"][:2], um1=a["um1"][:2], t=a["t"][:2],
               lam=a["lamy"][0].reshape(cfg.ny, cfg.nu), px=a["px"][0], py=a["py"][0])
    X0 = np.concatenate([a["X"][:2], a["X"][:2, -1:]], 1) * ps.sxa
    r = solve(par, torch.tensor(X0), torch.tensor(a["U"][:2] * ps.su))
    assert calls and set(calls) == {14} and len(calls) >= int(r.iters.max())


def _full_width(form):
    """The form's path's OCP in ``chip_smoke.py``, at full width."""
    from mpc_code_tpu_torch.examples import closed_loop_bench as cb
    from mpc_code_tpu_torch.examples import lmpc_loop_workload as lw
    from mpc_code_tpu_torch.examples.bench_workload import make_problem

    if form in ("lmpc", "clb"):
        cfg = lw.make_config() if form == "lmpc" else cb.make_config()
        return cfg, _port_ocp(cfg)
    kw = {"soft": dict(slacks=True, Ws=10.0 * np.eye(4)),
          "rows": dict(TermCons=True, H_eq=_heq(torch), G_ineq=_gin_smoke),
          "colloc": dict(Collocation=True)}[form]
    cfg, _, s, _ = make_problem("cpu", hessian="exact", **kw)
    return cfg, s


def _gin_smoke(x, u, y, d, t, px, py):
    """``chip_smoke.py::gineq_line``."""
    return torch.atleast_1d(297.5 - u[0] + 0.05 * (x[1] - 325.0))


@pytest.mark.parametrize("form,dims,ops", [
    ("lmpc", (5, 2, 0, 2, 3, 2), (2783, 2258)),
    ("clb", (3, 2, 0, 3, 3, 3), (1759, 1234)),
    ("soft", (7, 6, 4, 2, 3, 2), (61133, 23800)),
    ("rows", (3, 2, 3, 2, 3, 2), (45697, 10537)),
    ("colloc", (3, 2, 8, 2, 3, 2), (11132, 10562))])
def test_ops_per_lane_pinned_at_full_width(form, dims, ops):
    """What the generator emits for each form at its path's width, exact
    and Gauss-Newton: the count behind each build's bound.  Collocation's
    count holds its eight Newton steps, the implicit step's solves and the
    ODE's third derivatives on the u tangents."""
    from mpc_code_tpu_torch.solver.sweep_kernel import make_stage_sweep

    cfg, s = _full_width(form)
    assert (s.nxa, s.nu, s.ni, cfg.nd, cfg.npx, cfg.npy) == dims
    assert tuple(make_stage_sweep(s, h).ops_per_lane(*dims)
                 for h in ("exact", "gauss_newton")) == ops
