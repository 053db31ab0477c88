"""The port's ``build_model`` for linear models and C-matrix outputs against the JAX package, CPU, f64.

- The four LMPC example configs (``lmpc_wb``: ``A x + B u``, output
  disturbance ``Cd``; ``lmpc_cstr``: input disturbance ``Bd = I``;
  ``lmpc_nlplant``: affine around ``(xlin, ulin)``, ``Bd = B``;
  ``lmpcxp_nlplant``: affine output around ``(xlin, ylin)``, nx=4), each
  carried across by ``convert.config_from_numpy``: ``fx`` and ``fy`` at
  seeded points against JAX's, to 1e-12 (normalised ``|a-b|/(1+|b|)``;
  measured 0, bit for bit, on the four configs).  Also with LinPar, and
  the state map's Jacobians (``jacrev``) against the config's ``A`` and
  ``B``.
- The C-matrix output of a ``ContinuousModel`` and a ``DiscreteModel``
  with ``fy=None`` (the CSTR's RK4 model and the quadruple tank's map with
  ``C`` in place of their output functions), against JAX's (measured
  9.9e-14 through the RK4 model's sub-steps, 0 in the output).
- A model without C, fy or StateFeedback raises ``ValueError``, as in JAX.

A few seconds in one process on the CPU.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

LMPC = ("lmpc_wb", "lmpc_cstr", "lmpc_nlplant", "lmpcxp_nlplant")
TOL = 1e-12


def _configs(name, **kw):
    from mpc_code_tpu_torch.convert import config_from_numpy

    jmod = __import__(f"mpc_code_tpu.examples.{name}", fromlist=["make_config"])
    pmod = __import__(f"mpc_code_tpu_torch.examples.{name}", fromlist=["make_config"])
    jcfg = jmod.make_config(Nsim=5).replace(**kw)
    return jcfg, config_from_numpy(jcfg, pmod.make_config(Nsim=5).replace(**kw))


def _point(cfg, seed):
    """A seeded point (x, u, d, t, px, py) around the config's x0_m, u0."""
    rng = np.random.default_rng(seed)
    x = np.asarray(cfg.x0_m, float) * (1 + 0.05 * rng.normal(size=cfg.nx)) \
        + 0.1 * rng.normal(size=cfg.nx)
    u = np.asarray(cfg.u0, float) + rng.normal(size=cfg.nu)
    return (x, u, rng.normal(size=cfg.nd), float(rng.uniform(0, 30)),
            rng.normal(size=cfg.npx), rng.normal(size=cfg.npy))


def nerr(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float((np.abs(a - b) / (1 + np.abs(b))).max())


def _maps(jcfg, pcfg, seed):
    """(port, JAX) values of fx and fy at one seeded point."""
    from mpc_code_tpu.models import build_model as jbuild
    from mpc_code_tpu_torch.models import build_model

    jm, pm = jbuild(jcfg), build_model(pcfg)
    x, u, d, t, px, py = _point(jcfg, seed)
    J = [jnp.asarray(v) for v in (x, u, d, t, px, py)]
    P = [torch.as_tensor(v, dtype=torch.float64) for v in (x, u, d, t, px, py)]
    got = (pm.fx(P[0], P[1], pcfg.h, P[2], P[3], P[4]), pm.fy(P[0], P[1], P[2], P[3], P[5]))
    ref = (jm.fx(J[0], J[1], jcfg.h, J[2], J[3], J[4]), jm.fy(J[0], J[1], J[2], J[3], J[5]))
    for g in got:
        assert g.dtype == torch.float64
    return [g.numpy() for g in got], [np.asarray(r) for r in ref]


@pytest.mark.parametrize("name", LMPC)
def test_state_map_matches_jax(name):
    jcfg, pcfg = _configs(name)
    for seed in range(3):
        got, ref = _maps(jcfg, pcfg, seed)
        assert got[0].shape == (jcfg.nx,)
        assert nerr(got[0], ref[0]) <= TOL


@pytest.mark.parametrize("name", LMPC)
def test_output_map_matches_jax(name):
    jcfg, pcfg = _configs(name)
    for seed in range(3):
        got, ref = _maps(jcfg, pcfg, seed)
        assert got[1].shape == (jcfg.ny,)
        assert nerr(got[1], ref[1]) <= TOL


@pytest.mark.parametrize("name", ("lmpc_wb", "lmpc_nlplant"))
def test_linpar_maps_match_jax(name):
    jcfg, pcfg = _configs(name, LinPar=True)
    got, ref = _maps(jcfg, pcfg, 7)
    assert nerr(got[0], ref[0]) <= TOL and nerr(got[1], ref[1]) <= TOL


@pytest.mark.parametrize("name", LMPC)
def test_state_map_jacobians_are_the_matrices(name):
    """``jacrev`` of the linear state map gives ``A`` and ``B`` (the KF and
    the structured solver differentiate it so), in the lanes' dtype."""
    from torch.func import jacrev

    from mpc_code_tpu_torch.models import build_model

    _, pcfg = _configs(name)
    pm = build_model(pcfg)
    x, u, d, t, px, _ = (torch.as_tensor(v, dtype=torch.float32)
                         for v in _point(pcfg, 3))
    Ax, Bu = jacrev(pm.fx, argnums=(0, 1))(x, u, pcfg.h, d, t, px)
    assert Ax.dtype == torch.float32
    np.testing.assert_allclose(Ax.numpy(), pcfg.model.A, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(Bu.numpy(), pcfg.model.B, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ("nmpc", "nmpc_dis"))
def test_c_matrix_output_matches_jax(name):
    """``fy=None`` with ``C``: ``C x`` (plus ``Cd d`` under offree='lin')."""
    jcfg, pcfg = _configs(name)
    if name == "nmpc":
        C = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
        jcfg = jcfg.replace(model=dc.replace(jcfg.model, fy=None, C=C, Mx=2))
        pcfg = pcfg.replace(model=dc.replace(pcfg.model, fy=None, C=C, Mx=2))
    else:
        C = np.eye(2, 6, 2)
        jcfg = jcfg.replace(model=dc.replace(jcfg.model, fy=None, C=C))
        pcfg = pcfg.replace(model=dc.replace(pcfg.model, fy=None, C=C))
    for seed in range(3):
        got, ref = _maps(jcfg, pcfg, seed)
        assert nerr(got[0], ref[0]) <= TOL and nerr(got[1], ref[1]) <= TOL


def test_missing_output_map_raises():
    from mpc_code_tpu_torch.models import build_model

    _, pcfg = _configs("lmpc_wb")
    with pytest.raises(ValueError, match="output map missing"):
        build_model(pcfg.replace(model=dc.replace(pcfg.model, C=None)))
