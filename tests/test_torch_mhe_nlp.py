"""The MHE window NLP in the port (``ocp/mhe.py``) against the JAX package, CPU, f64.

ENMPC's MHE (``examples/enmpc.py``: the reactor's RK4 map at Mx_mhe=2,
N_mhe=4, n=4, p=2), carried across by ``convert.config_from_numpy``, as
it is and with y, v and w boxes added; seeded window data and decision
vectors.  Every value to 1e-12 (normalised ``|a-b|/(1+|b|)``):

- ``build_mhe_nlp``'s ``f`` and ``g``, plain, masked (the first window
  stage a pad stage) and with ``smooth_correction``; its bounds;
- ``build_structured_mhe``'s scaled ``dyn``, ``cost`` and ``ineq`` at
  structured stage 0 (the arrival stage), at a pad stage and at a live
  stage, with and without the boxes, the port's per-point parameters
  coming from the OCP's ``params`` hook where JAX indexes its pytree with
  ``k``; its bounds and scales;
- ``mhe_dual_zeros``'s shapes (with a leading lane axis) and
  ``shift_mhe_duals`` on seeded duals.

The JAX functions are jitted once per module.  A few seconds in one
process on the CPU.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

TOL = 1e-12
N = 4


def nerr(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float((np.abs(a - b) / (1 + np.abs(b))).max()) if a.size else 0.0


def _configs(boxed):
    from mpc_code_tpu.examples.enmpc import make_config as jmake
    from mpc_code_tpu_torch.convert import config_from_numpy
    from mpc_code_tpu_torch.examples.enmpc import make_config as pmake

    jcfg = jmake(Nsim=4)
    jcfg.estimator = dc.replace(jcfg.estimator, N_mhe=N, Mx_mhe=2)
    if boxed:
        jcfg.bounds = dc.replace(jcfg.bounds, ymin=np.array([-1.0, -2.0]),
                                 ymax=np.array([3.0, 2.0]), vmin=np.array([-0.5, -0.4]),
                                 vmax=np.array([0.5, 0.6]), wmin=-0.3 * np.ones(4),
                                 wmax=0.4 * np.ones(4))
    return jcfg, config_from_numpy(jcfg, pmake(Nsim=4))


def _parts(cfg, jax_side):
    """(fx_mhe, fy_es, f_obj_mhe) of either package."""
    if jax_side:
        from mpc_code_tpu.estimators.linear import build_augmented
        from mpc_code_tpu.models import build_model
        from mpc_code_tpu.models.costs import build_mhe_cost
        from mpc_code_tpu.models.model import build_mhe_model
    else:
        from mpc_code_tpu_torch.estimators.linear import build_augmented
        from mpc_code_tpu_torch.models import build_mhe_cost, build_mhe_model, build_model
    model = build_model(cfg)
    return (build_mhe_model(cfg, model), build_augmented(cfg, model).fy,
            build_mhe_cost(cfg.estimator.mhe_cost))


def _par(seed):
    """Seeded window data of one lane, the mask's first stage a pad stage."""
    rng = np.random.default_rng(seed)
    n, p, pidx = 4, 2, 2 * (N - 1)
    M = rng.normal(size=(n, n))
    Mc = rng.normal(size=(pidx, pidx))
    return dict(U=rng.uniform(0.2, 1.5, (N, 1)), Y=rng.uniform(0.1, 0.9, (N, p)),
                x_bar=np.array([0.8, 0.3, 0.02, -0.01]), P_inv=M @ M.T + np.eye(n),
                T=2.0 * np.arange(N, dtype=float), PX=0.01 * rng.normal(size=(N, 2)),
                PY=0.01 * rng.normal(size=(N, 2)), mask=np.arange(N) >= 1,
                Pycondx_inv=0.01 * (Mc @ Mc.T), Hbig=0.1 * rng.normal(size=pidx),
                Obig=rng.normal(size=(pidx, n)))


def _w(seed, nw):
    rng = np.random.default_rng(seed)
    return 0.5 + 0.2 * rng.normal(size=nw)


def _jpar(par):
    return {k: jnp.asarray(v) for k, v in par.items()}


def _tpar(par):
    return {k: torch.as_tensor(v) for k, v in par.items()}


CASES = [(False, False, False), (False, True, False), (False, False, True),
         (True, False, False), (True, True, True)]
IDS = ["plain", "masked", "smooth_corr", "boxed", "boxed_masked_corr"]


@pytest.mark.parametrize("boxed,maskable,corr", CASES, ids=IDS)
def test_dense_nlp_f_and_g(boxed, maskable, corr):
    from mpc_code_tpu.ocp.mhe import build_mhe_nlp as jbuild
    from mpc_code_tpu_torch.ocp.mhe import build_mhe_nlp

    jcfg, pcfg = _configs(boxed)
    js = jbuild(jcfg, *_parts(jcfg, True), N, N, smooth_correction=corr, maskable=maskable)
    ps = build_mhe_nlp(pcfg, *_parts(pcfg, False), N, N, smooth_correction=corr,
                       maskable=maskable)
    assert (ps.nlp.nw, ps.nlp.ng, ps.nxvw) == (js.nlp.nw, js.nlp.ng, js.nxvw)
    for a, b in ((ps.lbw, js.lbw), (ps.ubw, js.ubw), (ps.lbg, js.lbg), (ps.ubg, js.ubg)):
        np.testing.assert_array_equal(a, b)
    jf, jg = jax.jit(js.nlp.f), jax.jit(js.nlp.g)
    for seed in (0, 1):
        par, w = _par(seed), _w(seed + 10, ps.nlp.nw)
        assert nerr(ps.nlp.f(torch.as_tensor(w), _tpar(par)).numpy(),
                    jf(jnp.asarray(w), _jpar(par))) <= TOL
        assert nerr(ps.nlp.g(torch.as_tensor(w), _tpar(par)).numpy(),
                    jg(jnp.asarray(w), _jpar(par))) <= TOL


@pytest.mark.parametrize("boxed,maskable,corr", CASES, ids=IDS)
def test_structured_stage_functions(boxed, maskable, corr):
    from mpc_code_tpu.ocp.mhe import build_structured_mhe as jbuild
    from mpc_code_tpu_torch.ocp.mhe import build_structured_mhe
    from mpc_code_tpu_torch.solver.riccati import batch_params

    jcfg, pcfg = _configs(boxed)
    js, _ = jbuild(jcfg, *_parts(jcfg, True), N, N, smooth_correction=corr,
                   maskable=maskable)
    ps, _ = build_structured_mhe(pcfg, *_parts(pcfg, False), N, N, smooth_correction=corr,
                                 maskable=maskable, device="cpu")
    assert (ps.N, ps.nxa, ps.nu, ps.ni) == (js.N, js.nxa, js.nu, js.ni)
    for f in ("lbi", "ubi", "lbx", "ubx", "lbu", "ubu", "sxa", "su", "si"):
        np.testing.assert_array_equal(getattr(ps, f), getattr(js, f), err_msg=f)
    assert (ps.ineq is None) == (js.ineq is None) == (not boxed)
    fns = [("dyn", jax.jit(js.dyn), ps.dyn), ("cost", jax.jit(js.cost), ps.cost)]
    if boxed:
        fns.append(("ineq", jax.jit(js.ineq), ps.ineq))
    rng = np.random.default_rng(5)
    par = _par(2)
    pk = ps.params.stage(batch_params(_tpar(par), 1, torch.float64, "cpu", ps.params.ndim),
                         ps.N)
    assert nerr(ps.x0_of_p(batch_params(_tpar(par), 1, torch.float64, "cpu",
                                        ps.params.ndim))[0].numpy(),
                js.x0_of_p(_jpar(par))) <= TOL
    # k = 0: the arrival stage; k = 1: window stage 0, a pad stage when
    # masked; k = 3: a live stage
    for k in (0, 1, 3):
        pk_k = {key: v[k] for key, v in pk.items()}
        z, u = 0.5 + 0.2 * rng.normal(size=4), 0.1 * rng.normal(size=4)
        for name, jf, pf in fns:
            got = pf(torch.as_tensor(z), torch.as_tensor(u), pk_k).numpy()
            ref = jf(jnp.asarray(z), jnp.asarray(u), k, _jpar(par))
            assert np.isfinite(got).all()
            assert nerr(got, ref) <= TOL, (name, k)


@pytest.mark.parametrize("boxed", [False, True], ids=["plain", "boxed"])
def test_dual_zeros_and_shift(boxed):
    from mpc_code_tpu.ocp.mhe import mhe_dual_zeros as jzeros
    from mpc_code_tpu.ocp.mhe import shift_mhe_duals as jshift
    from mpc_code_tpu_torch.ocp.mhe import mhe_dual_zeros, shift_mhe_duals

    jcfg, pcfg = _configs(boxed)
    jz, pz = jzeros(jcfg, N), mhe_dual_zeros(pcfg, N, batch=3, device="cpu")
    assert set(pz) == set(jz)
    for k in jz:
        assert tuple(pz[k].shape) == (3,) + tuple(jz[k].shape), k
        assert (pz[k] == 0).all() if k != "sf" else (pz[k] == 1).all()
    assert pz["ok"].dtype == torch.bool
    rng = np.random.default_rng(6)
    d = {k: rng.normal(size=v.shape) for k, v in pz.items() if k != "ok"}
    d["ok"] = np.array([True, False, True])
    got = shift_mhe_duals({k: torch.as_tensor(v) for k, v in d.items()})
    for lane in range(3):
        ref = jshift({k: jnp.asarray(v[lane]) for k, v in d.items()})
        for k in ref:
            np.testing.assert_array_equal(got[k][lane].numpy(), np.asarray(ref[k]), err_msg=k)
