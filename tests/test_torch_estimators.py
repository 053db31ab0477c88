"""The port's plants and estimators against the JAX package, CPU, f64.

- ``build_plant``: the continuous plant of ``examples/nmpc.py`` (RK4,
  Mx=2) without and with the saturation guard (points outside the guard's
  box included), the discrete plant of ``examples/nmpc_dis.py``, the
  linear plant of ``lmpc_wb``, and the outputs from the user's ``fy``, from
  ``Cp`` and from StateFeedback, with LinPar's additive parameters
  non-zero; the nominal alias.  Seeded points, 3 lanes through
  ``torch.func.vmap`` against ``jax.vmap``.
- ``build_augmented`` for ``offree`` in {no, nl, lin}.
- ``kalman`` and ``ekf`` on nmpc's augmented model, ``kalss`` on
  nmpc_dis's with its Luenberger gain, ``kalss_gain`` on nmpc's nonlinear
  linearisation (x_ss, u_ss at the example's steady state) and on
  ``lmpc_wb``'s linear pair (the config's matrices, no model callables).
- The EKF in f32 stays in f32 (ROADMAP Queue 3, F9: forward mode through
  the RK4 sub-steps turned the state Jacobian into f64).

Every comparison holds the normalised error ``|a-b|/(1+|b|)`` to 1e-10.
Measured (builder's CPU run): ``kalss_gain`` on nmpc's linearisation
3.2e-11 (the DARE of the CSTR's stiff augmented pair magnifies the
Jacobians' rounding), every other comparison at most 1.7e-15.  About
23 s in one process.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch
from torch.func import vmap

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

TOL = 1e-10
LANES = 3
MX = 2


def _nerr(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float((np.abs(a - b) / (1 + np.abs(b))).max())


def _configs(name, **kw):
    """(JAX config, the port's config with the same numbers) of an example."""
    from mpc_code_tpu_torch.convert import config_from_numpy

    jmod = __import__(f"mpc_code_tpu.examples.{name}", fromlist=["make_config"])
    pmod = __import__(f"mpc_code_tpu_torch.examples.{name}", fromlist=["make_config"])
    jcfg = jmod.make_config(Nsim=5)
    if name == "nmpc":
        jcfg = jcfg.replace(model=dc.replace(jcfg.model, Mx=MX),
                            plant=dc.replace(jcfg.plant, Mx=MX))
    jcfg = jcfg.replace(**kw)
    pbase = pmod.make_config(Nsim=5).replace(**{k: v for k, v in kw.items()
                                                 if not dc.is_dataclass(v)})
    for k, v in kw.items():
        if dc.is_dataclass(v):
            pbase = pbase.replace(**{k: config_from_numpy(v, getattr(pbase, k))})
    return jcfg, config_from_numpy(jcfg, pbase)


def _draw(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, (LANES,) + tuple(np.shape(lo))) for lo, hi in shapes]


def _both(args):
    return [torch.as_tensor(a) for a in args], [jnp.asarray(a) for a in args]


def _hold(pfn, jfn, args, in_dims=None):
    p, j = _both(args)
    got = vmap(pfn, in_dims=in_dims or 0)(*p)
    ref = jax.vmap(jfn, in_axes=in_dims or 0)(*j)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64
        assert _nerr(g.numpy(), np.asarray(r)) <= TOL


NMPC_X = (np.array([0.3, 300.0, 0.5]), np.array([0.95, 345.0, 0.7]))
NMPC_U = (np.array([295.0, 0.0]), np.array([305.0, 0.25]))
PXP3 = (np.full(3, -0.01), np.full(3, 0.01))
PY2 = (np.full(2, -0.01), np.full(2, 0.01))
T = (np.array(0.0), np.array(20.0))


def _plant_pair(jcfg, pcfg):
    from mpc_code_tpu.models import build_model as jbm, build_plant as jbp
    from mpc_code_tpu_torch.models import build_model, build_plant

    return build_plant(pcfg, build_model(pcfg)), jbp(jcfg, jbm(jcfg))


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
def test_continuous_plant_matches_jax(clip):
    jcfg, pcfg = _configs("nmpc")
    if clip:
        lo, hi = np.array([0.4, 310.0, 0.55]), np.array([0.9, 340.0, 0.68])
        jcfg = jcfg.replace(plant=dc.replace(jcfg.plant, clip_lo=lo, clip_hi=hi))
        pcfg = pcfg.replace(plant=dc.replace(pcfg.plant, clip_lo=lo, clip_hi=hi))
    pp, jp = _plant_pair(jcfg, pcfg)
    assert not pp.nominal
    x, u, pxp, pxmp, t = _draw(1, (NMPC_X, NMPC_U, PXP3, PXP3, T))
    h = np.full(LANES, 0.2)
    _hold(pp.fx, jp.fx, (x, u, pxp, t, h, pxmp))
    pyp, pymp = _draw(2, (PY2, PY2))
    _hold(pp.fy, jp.fy, (x, u, pyp, t, pymp))


@pytest.mark.parametrize("form", ["Cp", "StateFeedback"])
def test_plant_output_forms_match_jax(form):
    if form == "Cp":
        jcfg, pcfg = _configs("nmpc")
        Cp = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
        jcfg = jcfg.replace(plant=dc.replace(jcfg.plant, fy=None, Cp=Cp))
        pcfg = pcfg.replace(plant=dc.replace(pcfg.plant, fy=None, Cp=Cp))
        pyd = PY2
    else:
        jcfg, pcfg = _configs("nmpc", StateFeedback=True, ny=3)
        pyd = PXP3
    pp, jp = _plant_pair(jcfg, pcfg)
    x, u, t = _draw(3, (NMPC_X, NMPC_U, T))
    pyp, pymp = _draw(4, (pyd, pyd))
    _hold(pp.fy, jp.fy, (x, u, pyp, t, pymp))


def test_discrete_plant_matches_jax():
    jcfg, pcfg = _configs("nmpc_dis")
    pp, jp = _plant_pair(jcfg, pcfg)
    x, u, pxp, pxmp, t = _draw(5, ((np.full(6, 1.0), np.full(6, 14.0)),
                                   (np.full(2, 30.0), np.full(2, 50.0)),
                                   (np.zeros(6), np.full(6, 0.5)),
                                   (np.zeros(6), np.full(6, 0.1)), T))
    h = np.full(LANES, 5.0)
    _hold(pp.fx, jp.fx, (x, u, pxp, t, h, pxmp))
    pyp, pymp = _draw(6, (PY2, PY2))
    _hold(pp.fy, jp.fy, (x, u, pyp, t, pymp))


def test_linear_plant_matches_jax():
    """``lmpc_wb``'s LinearPlant: matrices only, Cp output; the port's
    config carries the same matrices (its model form, LinearModel, is not
    needed by a non-nominal plant)."""
    from mpc_code_tpu.examples.lmpc_wb import make_config as make_jax
    from mpc_code_tpu.models import build_model as jbm, build_plant as jbp
    from mpc_code_tpu_torch import config as pc
    from mpc_code_tpu_torch.models import build_plant

    jcfg = make_jax()
    p = jcfg.plant
    pcfg = pc.MPCConfig(nx=4, nu=2, ny=2, nd=2,
                        plant=pc.LinearPlant(Ap=np.asarray(p.Ap), Bp=np.asarray(p.Bp),
                                             Cp=np.asarray(p.Cp)))
    pp, jp = build_plant(pcfg, None), jbp(jcfg, jbm(jcfg))
    x, u, pxp, pxmp, pyp, pymp, t = _draw(7, ((np.full(4, -1.0), np.full(4, 1.0)),
                                              (np.full(2, -0.5), np.full(2, 0.5)),
                                              (np.full(4, -0.1), np.full(4, 0.1)),
                                              (np.full(4, -0.1), np.full(4, 0.1)),
                                              PY2, PY2, T))
    _hold(pp.fx, jp.fx, (x, u, pxp, t, np.ones(LANES), pxmp))
    _hold(pp.fy, jp.fy, (x, u, pyp, t, pymp))


def test_nominal_plant_aliases_the_model():
    from mpc_code_tpu_torch.models import build_model, build_plant

    _, pcfg = _configs("nmpc", Fp_nominal=True)
    model = build_model(pcfg)
    pp = build_plant(pcfg, model)
    assert pp.nominal and pp.fx is model.fx and pp.fy is model.fy


def _aug_pair(jcfg, pcfg):
    from mpc_code_tpu.estimators.linear import build_augmented as jba
    from mpc_code_tpu.models import build_model as jbm
    from mpc_code_tpu_torch.estimators.linear import build_augmented
    from mpc_code_tpu_torch.models import build_model

    return build_augmented(pcfg, build_model(pcfg)), jba(jcfg, jbm(jcfg))


NMPC_CSI = (np.array([0.3, 300.0, 0.5, -0.02, 0.08]), np.array([0.95, 345.0, 0.7, 0.02, 0.12]))
DIS_X = (np.full(6, 1.0), np.full(6, 14.0))


@pytest.mark.parametrize("offree", ["no", "nl", "lin"])
def test_build_augmented_matches_jax(offree):
    if offree == "nl":
        jcfg, pcfg = _configs("nmpc")
        csi_box, u_box, px_box = NMPC_CSI, NMPC_U, PXP3
        h = 0.2
    else:
        dist = dict(offree="lin", Bd=np.full((6, 2), 0.01), Cd=np.eye(2))
        if offree == "no":
            dist = dict(offree="no", Bd=None, Cd=None)
        from mpc_code_tpu.config import DisturbanceModel

        jcfg, pcfg = _configs("nmpc_dis", dist=DisturbanceModel(**dist))
        n = 8 if offree == "lin" else 6
        csi_box = (np.full(n, 1.0), np.full(n, 14.0))
        u_box, px_box = (np.full(2, 30.0), np.full(2, 50.0)), (np.zeros(6), np.full(6, 0.1))
        h = 5.0
    pa, ja = _aug_pair(jcfg, pcfg)
    assert pa.n == ja.n
    csi, u, px, py, t = _draw(8, (csi_box, u_box, px_box, PY2, T))
    _hold(pa.fx, ja.fx, (csi, u, np.full(LANES, h), t, px))
    _hold(pa.fy, ja.fy, (csi, u, t, py))


def _filter_inputs(seed, n):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((LANES, n, n))
    P = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(n)
    return P


@pytest.mark.parametrize("which", ["ekf", "kalman"])
def test_filters_match_jax(which):
    """One step of the EKF and of the time-varying KF on nmpc's augmented
    model (the example's Q_kf and R_kf), at seeded estimates, covariances,
    inputs and measurements."""
    from mpc_code_tpu.estimators import ekf as jekf, kalman as jkal
    from mpc_code_tpu_torch.estimators import ekf, kalman

    jcfg, pcfg = _configs("nmpc")
    pa, ja = _aug_pair(jcfg, pcfg)
    xh, u, px, py, t = _draw(9, (NMPC_CSI, NMPC_U, PXP3, PY2, T))
    y = _draw(10, ((np.array([0.3, 0.5]), np.array([0.95, 0.7])),))[0]
    P = _filter_inputs(11, 5)
    Q, R = np.asarray(jcfg.estimator.Q_kf), np.asarray(jcfg.estimator.R_kf)
    pf, jf = (ekf, jekf) if which == "ekf" else (kalman, jkal)
    (yt, ut, Pt, xt, tt, pxt, pyt), (yj, uj, Pj, xj, tj, pxj, pyj) = _both((y, u, P, xh, t, px, py))
    got = pf(pa, 0.2, yt, ut, torch.as_tensor(Q), torch.as_tensor(R), Pt, xt, tt, pxt, pyt)
    ref = jax.vmap(lambda *a: jf(ja, 0.2, a[0], a[1], jnp.asarray(Q), jnp.asarray(R),
                                 *a[2:]))(yj, uj, Pj, xj, tj, pxj, pyj)
    for g, r in zip(got, ref):
        assert _nerr(g.numpy(), np.asarray(r)) <= TOL


def test_kalss_matches_jax():
    from mpc_code_tpu.estimators import kalss as jkalss
    from mpc_code_tpu_torch.estimators import kalss

    jcfg, pcfg = _configs("nmpc_dis")
    pa, ja = _aug_pair(jcfg, pcfg)
    K = np.asarray(jcfg.estimator.K, float)
    xh, u, py, t = _draw(12, ((np.full(8, 1.0), np.full(8, 14.0)),
                              (np.full(2, 30.0), np.full(2, 50.0)), PY2, T))
    y = _draw(13, ((np.full(2, 5.0), np.full(2, 13.0)),))[0]
    (yt, ut, xt, tt, pyt), (yj, uj, xj, tj, pyj) = _both((y, u, xh, t, py))
    got = kalss(pa, yt, ut, torch.as_tensor(K), xt, tt, pyt)
    ref = jax.vmap(lambda *a: jkalss(ja, a[0], a[1], jnp.asarray(K), *a[2:]))(yj, uj, xj, tj, pyj)
    assert _nerr(got.numpy(), np.asarray(ref)) <= TOL


def test_kalss_gain_nonlinear_matches_jax():
    """nmpc's model linearised at the example's steady state (offree='nl':
    the augmented Jacobian through the RK4), the example's Q_kf/R_kf."""
    from mpc_code_tpu.config import EstimatorConfig
    from mpc_code_tpu.estimators import kalss_gain as jgain
    from mpc_code_tpu.models import build_model as jbm
    from mpc_code_tpu_torch.estimators import kalss_gain
    from mpc_code_tpu_torch.models import build_model

    j0, _ = _configs("nmpc")
    est = dc.replace(j0.estimator, kind="kalss", x_ss=np.asarray(j0.x0_m),
                     u_ss=np.asarray(j0.u0))
    assert isinstance(est, EstimatorConfig)
    jcfg, pcfg = _configs("nmpc", estimator=est)
    got = kalss_gain(pcfg, build_model(pcfg)).numpy()
    assert got.shape == (5, 2)
    assert _nerr(got, np.asarray(jgain(jcfg, jbm(jcfg)))) <= TOL


def test_kalss_gain_linear_matches_jax():
    """``lmpc_wb``'s linear pair (offree='lin' with its Bd/Cd) with a
    seeded Q_kf/R_kf: A and C come from the config's matrices."""
    from mpc_code_tpu.examples.lmpc_wb import make_config as make_jax
    from mpc_code_tpu.estimators import kalss_gain as jgain
    from mpc_code_tpu.models import build_model as jbm
    from mpc_code_tpu_torch import config as pc
    from mpc_code_tpu_torch.estimators import kalss_gain

    Qk, Rk = np.diag([1e-3, 2e-3, 1e-3, 3e-3, 1.0, 0.5]), 1e-2 * np.eye(2)
    jcfg = make_jax()
    jcfg = jcfg.replace(estimator=dc.replace(jcfg.estimator, kind="kalss", K=None,
                                             Q_kf=Qk, R_kf=Rk))
    m, d = jcfg.model, jcfg.dist
    pcfg = pc.MPCConfig(
        nx=4, nu=2, ny=2, nd=2,
        model=pc.LinearModel(A=np.asarray(m.A), B=np.asarray(m.B), C=np.asarray(m.C)),
        dist=pc.DisturbanceModel(offree="lin", Bd=np.asarray(d.Bd), Cd=np.asarray(d.Cd)),
        estimator=pc.EstimatorConfig(kind="kalss", Q_kf=Qk, R_kf=Rk))
    got = kalss_gain(pcfg, None).numpy()
    assert _nerr(got, np.asarray(jgain(jcfg, jbm(jcfg)))) <= TOL


def test_ekf_stays_in_f32():
    from mpc_code_tpu_torch.estimators import ekf

    _, pcfg = _configs("nmpc")
    from mpc_code_tpu_torch.estimators.linear import build_augmented
    from mpc_code_tpu_torch.models import build_model

    pa = build_augmented(pcfg, build_model(pcfg))
    xh, u, px, py, t = (torch.as_tensor(a, dtype=torch.float32)
                        for a in _draw(14, (NMPC_CSI, NMPC_U, PXP3, PY2, T)))
    P = torch.as_tensor(_filter_inputs(15, 5), dtype=torch.float32)
    Q = torch.as_tensor(pcfg.estimator.Q_kf, dtype=torch.float32)
    R = torch.as_tensor(pcfg.estimator.R_kf, dtype=torch.float32)
    out = ekf(pa, 0.2, xh[:, [0, 2]], u, Q, R, P, xh, t, px, py)
    assert all(o.dtype == torch.float32 for o in out)


def test_scheduled_feed_flow_keeps_the_state_dtype():
    """ROADMAP Queue 3, F10: the nmpc plant's scheduled feed flow F0 (0.1,
    0.15, 0.08) is exact in f64; ``torch.where`` on two Python floats had
    rounded it to f32, 4.7e-9 off JAX after one RK4 interval."""
    from mpc_code_tpu_torch.examples.nmpc import Ar, plant_fxp

    x = torch.tensor([0.8, 330.0, 0.6], dtype=torch.float64)
    u = torch.tensor([300.0, 0.05], dtype=torch.float64)
    for t, F0 in ((1.0, 0.1), (10.0, 0.15), (20.0, 0.08), (30.0, 0.1)):
        dx = plant_fxp(x, torch.tensor(t, dtype=torch.float64), u, None, None)
        assert dx.dtype == torch.float64
        assert float(dx[2]) == (F0 - 0.05) / Ar
