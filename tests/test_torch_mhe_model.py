"""The MHE's building blocks in the port against the JAX package, CPU, f64.

- ``ops/smalllin.py::inv`` on a batch with one exactly singular lane: the
  other lanes against JAX's vmapped ``inv`` to 1e-12 (normalised
  ``|a-b|/(1+|b|)``), the singular lane NaN in the port alone (JAX's is
  non-finite there too), where ``torch.linalg.inv`` raises for the batch.
- ``models/costs.py::build_mhe_cost`` in its three forms: LP (``r_w``,
  ``r_v``, no abs: the reference's quirk), QP and the user's callable, at
  seeded points, to 1e-12.
- ``models/model.py::build_mhe_model`` to 1e-12 at seeded points: the
  continuous MHE map by RK4 (Mx_mhe=2) with ``+ Bd d`` under
  offree='lin', a non-identity ``G w`` and LinPar; a discrete MHE map; and
  the main loop's augmentation of the controller model when the config
  gives no MHE map.

A few seconds in one process on the CPU.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

TOL = 1e-12


def nerr(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float((np.abs(a - b) / (1 + np.abs(b))).max())


def test_inv_nan_on_singular_lane_only():
    from mpc_code_tpu.ops.smalllin import inv as jinv
    from mpc_code_tpu_torch.ops.smalllin import inv

    rng = np.random.default_rng(0)
    A = rng.normal(size=(6, 4, 4)) + 3 * np.eye(4)
    bad = 3
    A[bad, :, 2] = 0.0                          # an exactly singular lane
    got = inv(torch.as_tensor(A)).numpy()
    ref = np.asarray(jax.vmap(jinv)(jnp.asarray(A)))
    ok = np.arange(6) != bad
    assert nerr(got[ok], ref[ok]) <= TOL
    assert np.isnan(got[bad]).all() and np.isfinite(got[ok]).all()
    assert not np.isfinite(ref[bad]).all()
    with pytest.raises(RuntimeError):
        torch.linalg.inv(torch.as_tensor(A))


def _user_cost(xp):
    def f(w, v, t):
        return 0.5 * (w @ w + 2.0 * v @ v) + 0.1 * t * xp.sum(w)

    return f


@pytest.mark.parametrize("form", ["lp", "qp", "user"])
def test_build_mhe_cost(form):
    from mpc_code_tpu.config import MHECost as JCost
    from mpc_code_tpu.models.costs import build_mhe_cost as jbuild
    from mpc_code_tpu_torch.config import MHECost
    from mpc_code_tpu_torch.models.costs import build_mhe_cost

    rng = np.random.default_rng(1)
    n, p = 4, 2
    if form == "lp":
        kw = dict(r_w=rng.normal(size=(1, n)), r_v=rng.normal(size=(1, p)))
        jc, pc = JCost(**kw), MHECost(**kw)
    elif form == "qp":
        M = rng.normal(size=(n, n))
        kw = dict(Q=M @ M.T + np.eye(n), R=np.diag(rng.uniform(1, 2, p)))
        jc, pc = JCost(**kw), MHECost(**kw)
    else:
        jc, pc = JCost(f_obj=_user_cost(jnp)), MHECost(f_obj=_user_cost(torch))
    jf, pf = jbuild(jc), build_mhe_cost(pc)
    for _ in range(3):
        w, v, t = rng.normal(size=n), rng.normal(size=p), float(rng.uniform(0, 10))
        got = pf(torch.as_tensor(w), torch.as_tensor(v), torch.tensor(t, dtype=torch.float64))
        assert nerr(got.numpy(), jf(jnp.asarray(w), jnp.asarray(v), t)) <= TOL


def _dis_map(xp):
    def fx(x, u, d, t, px, w):
        return xp.stack([0.9 * x[0] + 0.1 * u[0] * x[1] + 0.05 * d[0],
                         0.8 * x[1] + 0.2 * xp.sin(x[0]) + 0.01 * t])

    return fx


def _configs(case):
    """(JAX config, port config) of the MHE map case; the port's arrays
    carried across by ``convert.config_from_numpy``."""
    from mpc_code_tpu.config import DisturbanceModel as JDist
    from mpc_code_tpu_torch.config import DisturbanceModel
    from mpc_code_tpu_torch.convert import config_from_numpy

    rng = np.random.default_rng(2)
    name = "nmpc" if case == "augmented" else "enmpc"
    jmod = __import__(f"mpc_code_tpu.examples.{name}", fromlist=["make_config"])
    pmod = __import__(f"mpc_code_tpu_torch.examples.{name}", fromlist=["make_config"])
    jcfg, pbase = jmod.make_config(Nsim=4), pmod.make_config(Nsim=4)
    n = jcfg.nx + jcfg.nd
    G = np.eye(n) + 0.3 * rng.normal(size=(n, n))
    if case == "augmented":
        jcfg.estimator = dc.replace(jcfg.estimator, kind="mhe", G_mhe=G)
        pbase.estimator = dc.replace(pbase.estimator, kind="mhe")
    else:
        Bd = rng.normal(size=(jcfg.nx, jcfg.nd))
        jcfg = jcfg.replace(LinPar=True, dist=JDist(offree="lin", Bd=Bd, Cd=np.eye(jcfg.nd)))
        pbase = pbase.replace(LinPar=True, dist=DisturbanceModel(
            offree="lin", Bd=Bd, Cd=np.eye(jcfg.nd)))
        jcfg.estimator = dc.replace(jcfg.estimator, G_mhe=G, Mx_mhe=2)
        if case == "dis":
            jcfg.estimator = dc.replace(jcfg.estimator, fx_mhe_cont=None,
                                        fx_mhe_dis=_dis_map(jnp))
            pbase.estimator = dc.replace(pbase.estimator, fx_mhe_cont=None,
                                         fx_mhe_dis=_dis_map(torch))
    return jcfg, config_from_numpy(jcfg, pbase)


@pytest.mark.parametrize("case", ["cont", "dis", "augmented"])
def test_build_mhe_model(case):
    from mpc_code_tpu.models import build_model as jmodel
    from mpc_code_tpu.models.model import build_mhe_model as jbuild
    from mpc_code_tpu_torch.models import build_mhe_model, build_model

    jcfg, pcfg = _configs(case)
    jf = jax.jit(jbuild(jcfg, jmodel(jcfg)), static_argnums=2)
    pf = build_mhe_model(pcfg, build_model(pcfg))
    n = pcfg.nx + pcfg.nd
    rng = np.random.default_rng(3)
    x0 = np.concatenate([np.asarray(pcfg.x0_m, float), np.zeros(pcfg.nd)])
    for _ in range(3):
        csi = x0 * (1 + 0.05 * rng.normal(size=n)) + 0.05 * rng.normal(size=n)
        u = np.asarray(pcfg.u0, float) + 0.1 * np.abs(rng.normal(size=pcfg.nu))
        w = 0.1 * rng.normal(size=n)
        px = 0.01 * rng.normal(size=pcfg.npx)
        t = float(rng.uniform(0, 5))
        ref = jf(jnp.asarray(csi), jnp.asarray(u), pcfg.h, t, jnp.asarray(w), jnp.asarray(px))
        got = pf(torch.as_tensor(csi), torch.as_tensor(u), pcfg.h,
                 torch.tensor(t, dtype=torch.float64), torch.as_tensor(w), torch.as_tensor(px))
        assert got.shape == (n,)
        assert nerr(got.numpy(), ref) <= TOL, case
