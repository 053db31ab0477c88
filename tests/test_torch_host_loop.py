"""The port's host loop ``ClosedLoop`` (``loop/simulator.py``) against the JAX package's, CPU, f64.

Each run against JAX's ``ClosedLoop`` on the same config (RK4 at Mx=2
where the model integrates), every history key but the timings within
1e-8 (``assert_allclose`` rtol = atol = 1e-8) and the statuses equal; the
first solved NLP inputs (``first_nlps``) and the end-of-run state
(``final_state``) too:

- ``lmpc_wb`` reduced (Nsim=8, N=10): the Luenberger observer;
- ``nmpc`` at N=5, Nsim=5: the EKF, output noise (the same numpy draws);
- the modifier-adaptation config of ``tests/test_adaptation.py:49-67``
  (Nsim=5): LAMBDA, COR, Upopt and Ypopt too;
- ``nmpc`` with ``estimating=True`` (Nsim=5): no target, no OCP;
- the same reactor with ``ssjacid=True`` and no adaptation: the model
  replaced by its linearisation at the identified steady state.

Also: ``check_numerics`` raising ``FloatingPointError`` on a NaN parameter
schedule (after ``tests/test_closed_loop.py:74``); ``make_mpc_step`` with
``Adaptation=True`` on 2 lanes against JAX's step (3 steps); the
command line ``python -m mpc_code_tpu_torch.examples`` (``--list``, and
``enmpc --cpu --nsim 2 --n 5 --save``) in a subprocess that imports no
JAX module.  The fixtures through ``ClosedLoop`` are in
``test_torch_host_fixtures.py``.

JAX's loops are jitted by its ``ClosedLoop``; each reference runs once per
module.  About 150 s in one process on the CPU, most of it JAX's compiles
(the command line 20 s).
"""

import dataclasses as dc
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_target_adapt import jax_adaptation_config, port_adaptation_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMING = ("TIME_SS", "TIME_DYN")


def _example(name, Nsim, N, Mx=None, **kw):
    from mpc_code_tpu_torch.convert import config_from_numpy

    jmod = __import__(f"mpc_code_tpu.examples.{name}", fromlist=["make_config"])
    pmod = __import__(f"mpc_code_tpu_torch.examples.{name}", fromlist=["make_config"])
    jcfg = jmod.make_config(Nsim=Nsim).replace(N=N, **kw)
    if Mx is not None:
        jcfg = jcfg.replace(model=dc.replace(jcfg.model, Mx=Mx),
                            plant=dc.replace(jcfg.plant, Mx=Mx))
    return jcfg, config_from_numpy(jcfg, pmod.make_config(Nsim=Nsim))


def _reactor(Nsim, **kw):
    return (jax_adaptation_config(Nsim).replace(**kw),
            port_adaptation_config(Nsim).replace(**kw))


CASES = {
    "lmpc_wb": lambda: _example("lmpc_wb", 8, 10),
    "nmpc": lambda: _example("nmpc", 5, 5, Mx=2),
    "adaptation": lambda: _reactor(5),
    "estimating": lambda: _example("nmpc", 5, 5, Mx=2, estimating=True),
    "ssjacid": lambda: _reactor(4, Adaptation=False, ssjacid=True),
}


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    from mpc_code_tpu.loop import ClosedLoop as JLoop
    from mpc_code_tpu_torch.loop import ClosedLoop

    jcfg, pcfg = CASES[request.param]()
    jl, pl = JLoop(jcfg), ClosedLoop(pcfg, device="cpu")
    return request.param, (jl, jl.run()), (pl, pl.run())


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    if ref.dtype.kind in "iub":
        np.testing.assert_array_equal(got, ref, err_msg=what)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-8, err_msg=what)


def test_history_matches_jax(runs):
    name, (_, Hj), (_, Hp) = runs
    assert set(Hp) == set(Hj)
    for k in Hj:
        if k not in TIMING:
            _close(Hp[k], Hj[k], f"{name}: {k}")
    assert len(Hp["TIME_SS"]) == len(Hj["TIME_SS"])
    if name == "adaptation":
        assert np.abs(Hp["LAMBDA"][-1]).max() > 1e-3 and Hp["Upopt"].shape == (5, 1)
    if name == "estimating":
        assert len(Hp["U"]) == 0 and len(Hp["X_HAT"]) == 5
    if name != "estimating":
        assert (Hp["STATUS_DYN"] != 2).all()


def test_first_nlps_and_final_state_match_jax(runs):
    name, (jl, _), (pl, _) = runs
    assert set(pl.first_nlps) == set(jl.first_nlps)
    for kind, ref in jl.first_nlps.items():
        got = pl.first_nlps[kind]
        assert got["ksim"] == ref["ksim"]
        for k in ("w0", "lbw", "ubw"):
            if k in ref:
                _close(got[k], ref[k], f"{name}: first_nlps[{kind}][{k}]")
        assert set(got["par"]) == set(ref["par"])
        for k, v in ref["par"].items():
            _close(got["par"][k], v, f"{name}: first_nlps[{kind}].par[{k}]")
    assert set(pl.final_state) == set(jl.final_state)
    for k, v in jl.final_state.items():
        if v is None or isinstance(v, (bool, float)):
            assert pl.final_state[k] == v, k
        else:
            _close(pl.final_state[k], v, f"{name}: final_state[{k}]")
    if name == "ssjacid":
        from mpc_code_tpu_torch.config import LinearModel

        assert isinstance(pl.cfg.model, LinearModel)
        _close(pl.cfg.model.A, jl.cfg.model.A, "identified A")


def test_check_numerics_raises_on_nan():
    from mpc_code_tpu_torch.examples.lmpc_wb import make_config
    from mpc_code_tpu_torch.loop import ClosedLoop

    cfg = make_config(Nsim=2).replace(N=10, check_numerics=True)
    loop = ClosedLoop(cfg, device="cpu")
    assert loop.check_numerics and np.isfinite(loop.run()["U"]).all()
    bad = cfg.replace(def_px=lambda t: np.full(4, np.nan))
    with pytest.raises(FloatingPointError):
        ClosedLoop(bad, device="cpu").run()


def test_batched_adaptation_step_matches_jax():
    import jax
    import jax.numpy as jnp

    from mpc_code_tpu.loop import batched as jb
    from mpc_code_tpu.loop.schedules import make_step_inputs as jmsi
    from mpc_code_tpu_torch.loop import batched as pb
    from mpc_code_tpu_torch.loop.schedules import StepInput, make_step_inputs

    nsim = 3
    jcfg, pcfg = _reactor(nsim)
    x0 = np.array([[0.9, 0.1], [0.85, 0.15]])
    # JAX's step jitted for one lane and called per lane (the arithmetic of
    # its vmapped step; about half the compile time)
    jstep = jax.jit(jb.make_mpc_step(jcfg))
    jcs = [jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), jb.init_carry(jcfg, jnp.asarray(x)))
           for x in x0]
    pstep = pb.make_mpc_step(pcfg, device="cpu")
    pc = pb.init_carry(pcfg, torch.as_tensor(x0), device="cpu")
    assert pc.lam.shape == (2, 2, 1)
    jin, pin = jmsi(jcfg, nsim), make_step_inputs(pcfg, nsim)
    for k in range(nsim):
        inp = jax.tree.map(lambda a: jnp.asarray(a[k]), jin)
        lanes = [jstep(c, inp) for c in jcs]
        jcs = [c for c, _ in lanes]
        jo = jax.tree.map(lambda *a: jnp.stack(a), *[o for _, o in lanes])
        pc, po = pstep(pc, StepInput(*(a[k] for a in pin)))
        for f in ("u", "x", "xs", "us", "lam", "cor", "upopt", "ypopt", "status_ss",
                  "status_dyn", "ocp_iters"):
            _close(getattr(po, f).numpy(), np.asarray(getattr(jo, f)), f"step {k}: {f}")
    H = pb.history_from_outputs(pb.stack_outputs([po]))
    assert {"LAMBDA", "COR", "Upopt", "Ypopt"} <= set(H)


def _run_cli(args, tmp_path):
    script = (
        "import json, sys\n"
        "before = set(sys.modules)\n"
        "from mpc_code_tpu_torch.examples.__main__ import main\n"
        "import mpc_code_tpu_torch.loop, mpc_code_tpu_torch.native\n"
        f"rc = main({args!r})\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'mpc_code_tpu'))\n"
        "print(json.dumps(dict(rc=rc, bad=bad)))\n")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=str(tmp_path), env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["rc"] == 0 and res["bad"] == []
    return out.stdout


def test_command_line_lists_the_examples(tmp_path):
    out = _run_cli(["--list"], tmp_path)
    assert out.split()[:7] == ["lmpc_wb", "lmpc_cstr", "lmpc_nlplant", "lmpcxp_nlplant",
                               "nmpc", "nmpc_dis", "enmpc"]


def test_command_line_runs_an_example_on_the_cpu(tmp_path):
    from mpc_code_tpu_torch.utils.io import load_history

    path = str(tmp_path / "enmpc.npz")
    out = _run_cli(["enmpc", "--cpu", "--nsim", "2", "--n", "5", "--save", path], tmp_path)
    assert "enmpc: 2 steps on cpu" in out and "OCP solves ok 2/2" in out
    H, meta = load_history(path)
    assert H["U"].shape == (2, 1) and H["X_KF"].shape == (2, 4)
    assert float(meta["h"]) == 2.0 and np.isfinite(H["Yp"]).all()
