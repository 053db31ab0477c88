"""The port's ``utils/aot.py``: the content hash, the artifact key and the
kernel-library artifact cache (``export_cached``, the runner's
``aot_key``), held to the JAX package's ``tests/test_aot.py`` where the
two meet.  On the CPU an artifact holds no library; its key, its hit and
miss and the results it serves are what is tested here (the card's run
checks that a second process builds nothing: ``chip_smoke.py``'s ``aot``
phase)."""

import dataclasses as dc
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

YSP = np.array([0.2, 0.0, 0.0])

# a module-level constant read by a function (ADVICE.md: an edited global
# array must change the hash)
_GAIN = np.array([1.0, 2.0])


def _uses_global(x):
    return x * _GAIN


def _artifacts(d):
    return sorted(p for p in os.listdir(d) if os.path.isdir(os.path.join(d, p)))


def test_content_hash_config_identity():
    """``test_aot.py:76-106`` on the port's ``examples/nmpc.py``."""
    from mpc_code_tpu_torch.examples.nmpc import make_config
    from mpc_code_tpu_torch.utils.aot import content_hash

    h1 = content_hash(make_config())
    assert h1 == content_hash(make_config())
    assert content_hash(make_config().replace(N=49)) != h1
    cfg3 = make_config()
    q = np.asarray(cfg3.stage_cost.Q).copy()
    q[0, 0] += 1e-9
    assert content_hash(cfg3.replace(stage_cost=dc.replace(cfg3.stage_cost, Q=q))) != h1

    a = np.array([1.0, 2.0])

    def mk(arr):
        def f(x):
            return x + arr
        return f

    assert content_hash(mk(a)) == content_hash(mk(a.copy()))
    assert content_hash(mk(a)) != content_hash(mk(np.array([1.0, 3.0])))
    # tensors hash by dtype, shape and bytes
    t = torch.arange(4.0, dtype=torch.float64)
    assert content_hash(t) == content_hash(t.clone())
    assert content_hash(t) != content_hash(t.to(torch.float32))
    assert content_hash(t) != content_hash(t.reshape(2, 2))


def test_edited_global_and_knob_change_the_key(monkeypatch):
    from mpc_code_tpu_torch.utils.aot import KNOBS, artifact_key, content_hash

    global _GAIN
    h1 = content_hash(_uses_global)
    old = _GAIN
    try:
        _GAIN = np.array([1.0, 2.5])
        assert content_hash(_uses_global) != h1
    finally:
        _GAIN = old
    assert content_hash(_uses_global) == h1

    args = (torch.zeros(4, 3, dtype=torch.float64),)
    assert set(KNOBS) == {"MPC_TPU_CHECK_NUMERICS", "MPC_TPU_AOT_CACHE",
                          "MPC_TPU_SWEEP_AUTOTUNE"}
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    k0 = artifact_key("k", args)
    monkeypatch.setenv("MPC_TPU_CHECK_NUMERICS", "1")
    assert artifact_key("k", args) != k0
    monkeypatch.delenv("MPC_TPU_CHECK_NUMERICS")
    assert artifact_key("k", args) == k0
    assert artifact_key("k", (torch.zeros(4, 3, dtype=torch.float32),)) != k0
    assert artifact_key("k", (torch.zeros(5, 3, dtype=torch.float64),)) != k0
    assert artifact_key("k2", args) != k0


def test_source_hash_covers_kernels_and_leaves_out_builds(tmp_path):
    from mpc_code_tpu_torch.utils.aot import tree_hash

    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text("__global__ void k() {}")
    (tmp_path / "m.py").write_text("X = 1")
    h = tree_hash(str(tmp_path))
    (tmp_path / "_build" / "k-0").mkdir(parents=True)
    (tmp_path / "_build" / "k-0" / "gen.cuh").write_text("#define A 1")
    (tmp_path / "notes.txt").write_text("not a source")
    assert tree_hash(str(tmp_path)) == h
    (tmp_path / "csrc" / "k.cu").write_text("__global__ void k() { }")
    assert tree_hash(str(tmp_path)) != h


def _linear_cfg(cfg_mod):
    """``test_aot.py:22-35``'s LinearModel problem in either package."""
    A = np.array([[0.9, 0.1], [0.0, 0.8]])
    B = np.array([[0.0], [1.0]])
    return cfg_mod.MPCConfig(
        nx=2, nu=1, ny=2, nd=2, Nsim=5, N=4, h=1.0,
        model=cfg_mod.LinearModel(A=A, B=B, C=np.eye(2)),
        plant=cfg_mod.LinearPlant(Ap=A, Bp=B, Cp=np.eye(2)),
        dist=cfg_mod.DisturbanceModel(offree="no"),
        x0_p=np.ones(2), x0_m=np.ones(2), u0=np.zeros(1),
        ss_cost=cfg_mod.SSCost(Qss=np.eye(2), Rss=np.zeros((1, 1))),
        stage_cost=cfg_mod.StageCost(Q=np.eye(2), R=0.1 * np.eye(1)),
        bounds=cfg_mod.Bounds(umin=np.array([-2.0]), umax=np.array([2.0])),
    )


def _jax_linear_solve(x0s):
    """``test_aot.py:7-53``'s vmapped JAX solve of the 8 lanes."""
    import jax
    import jax.numpy as jnp

    import mpc_code_tpu.config as jc
    from mpc_code_tpu.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu.solver.riccati import build_structured_ocp, make_structured_solver

    cfg = _linear_cfg(jc)
    model = build_model(cfg)
    socp = build_structured_ocp(cfg, model, build_stage_cost(cfg.stage_cost),
                                build_terminal_cost(cfg))
    solve = make_structured_solver(socp, jc.SolverOptions(max_iter=30))

    def lane(x0):
        par = dict(x0=x0, xs=jnp.zeros(2), us=jnp.zeros(1), d=jnp.zeros(2),
                   um1=jnp.zeros(1), t=jnp.asarray(0.0),
                   lam=jnp.zeros((2, 1)),
                   px=jnp.zeros((4, cfg.npx)), py=jnp.zeros((4, cfg.npy)))
        X0 = jnp.tile(x0[None], (5, 1))
        U0 = jnp.zeros((4, 1))
        return solve(par, X0, U0)

    return jax.jit(jax.vmap(lane))(jnp.asarray(x0s))


def test_export_cached_round_trip(tmp_path):
    """``test_aot.py:7-60``: a first construction saves the artifact, a
    second loads it (the manifest's mtime unchanged), both serve JAX's
    answers, and another key gives a second artifact."""
    import mpc_code_tpu_torch.config as pc
    from mpc_code_tpu_torch.models import build_model, build_stage_cost, build_terminal_cost
    from mpc_code_tpu_torch.solver.riccati import build_structured_ocp, make_structured_solver
    from mpc_code_tpu_torch.utils.aot import export_cached

    cfg = _linear_cfg(pc)
    socp = build_structured_ocp(cfg, build_model(cfg), build_stage_cost(cfg.stage_cost),
                                build_terminal_cost(cfg), device="cpu")
    solve = make_structured_solver(socp, pc.SolverOptions(max_iter=30))

    def fn(x0s):
        par = dict(x0=x0s, xs=np.zeros(2), us=np.zeros(1), d=np.zeros(2), um1=np.zeros(1),
                   t=0.0, lam=np.zeros((2, 1)), px=np.zeros((4, cfg.npx)),
                   py=np.zeros((4, cfg.npy)))
        return solve(par, x0s[:, None].expand(-1, 5, -1), torch.zeros(len(x0s), 4, 1,
                                                                       dtype=x0s.dtype))

    x0_np = np.random.default_rng(0).normal(size=(8, 2))
    x0s = torch.as_tensor(x0_np)
    c1 = export_cached(fn, "test-lane", (x0s,), cache_dir=str(tmp_path))
    arts = _artifacts(tmp_path)
    assert len(arts) == 1
    manifest = tmp_path / arts[0] / "manifest.json"
    assert manifest.exists()
    mtime = manifest.stat().st_mtime_ns
    c2 = export_cached(fn, "test-lane", (x0s,), cache_dir=str(tmp_path))
    assert manifest.stat().st_mtime_ns == mtime, "should load, not re-export"

    ref = _jax_linear_solve(x0_np)
    outs = [c(x0s) for c in (c1, c2)]
    for out in outs:
        np.testing.assert_array_equal(out.status.numpy(), np.asarray(ref.status))
        assert np.abs(out.U.numpy() - np.asarray(ref.U)).max() <= 1e-8
    np.testing.assert_array_equal(outs[0].U.numpy(), outs[1].U.numpy())

    export_cached(fn, "test-lane-2", (x0s,), cache_dir=str(tmp_path))
    assert len(_artifacts(tmp_path)) == 2
    # a corrupt artifact is rebuilt
    manifest.write_text("{not json")
    export_cached(fn, "test-lane", (x0s,), cache_dir=str(tmp_path))
    assert manifest.read_text().startswith("{") and '"libraries"' in manifest.read_text()


def test_runner_auto_aot_key_and_refusals(tmp_path, monkeypatch):
    """``test_aot.py:109-149``: the same config from another construction
    loads the artifact, a one-field change misses; ``aot_key`` with a mesh
    and the AOT runner with a StepInput stack raise JAX's ValueErrors."""
    from mpc_code_tpu_torch.examples.closed_loop_bench import small_cfg
    from mpc_code_tpu_torch.loop.schedules import make_step_inputs
    from mpc_code_tpu_torch.parallel import make_closed_loop_runner

    monkeypatch.setenv("MPC_TPU_AOT_CACHE", str(tmp_path))
    x0s = np.tile(np.asarray(small_cfg(N=4).x0_p, float), (4, 1))

    r1 = make_closed_loop_runner(small_cfg(N=4), 2, 4, ysp=YSP, aot_key="auto", device="cpu")
    _, o1 = r1(x0s)
    arts = _artifacts(tmp_path)
    assert len(arts) == 1
    manifest = tmp_path / arts[0] / "manifest.json"
    mtime = manifest.stat().st_mtime_ns

    r2 = make_closed_loop_runner(small_cfg(N=4), 2, 4, ysp=YSP, aot_key="auto", device="cpu")
    _, o2 = r2(x0s)
    assert _artifacts(tmp_path) == arts and manifest.stat().st_mtime_ns == mtime
    np.testing.assert_array_equal(o1.u.numpy(), o2.u.numpy())

    make_closed_loop_runner(small_cfg(N=5), 2, 4, ysp=YSP, aot_key="auto", device="cpu")
    assert len(_artifacts(tmp_path)) == 2

    with pytest.raises(ValueError, match="unsharded"):
        make_closed_loop_runner(small_cfg(N=4), 2, 4, mesh=object(), aot_key="auto")
    with pytest.raises(ValueError, match="StepInput"):
        r1(x0s, make_step_inputs(small_cfg(N=4), 2))
    with pytest.raises(ValueError, match="exported for x0"):
        r1(x0s.astype(np.float32))


def test_a_loaded_library_is_noted_inside_a_recording(tmp_path):
    """F14 (ROADMAP Queue 3): ``cuda_build.build`` of a key this process
    has loaded already, inside ``recording()`` (an AOT export), called
    ``used()`` while it held the lock that ``used()`` takes again, and the
    process stopped there (the bench port's runner on the card, once its
    kernel-5 build was loaded before the export).  The build returns the
    loaded library, and the recording notes it."""
    import threading

    from mpc_code_tpu_torch.ops import cuda_build

    gen = {"mpc_stage_gen.cuh": "// a header no build writes\n"}
    defines = {"MPC_DTYPE_BITS": "32"}
    key = cuda_build.build_key("stage_sweep.cu", defines, gen)
    lib_dir = tmp_path / f"stage_sweep-{key}"
    loaded = cuda_build.BuiltLibrary(None, str(lib_dir / "libstage_sweep.so"), "")
    cuda_build._LOADED[key] = loaded
    out = {}

    def run():
        with cuda_build.recording() as seen:
            out["lib"] = cuda_build.build("stage_sweep", "stage_sweep.cu", defines=defines,
                                          generated=gen)
            out["seen"] = dict(seen)

    try:
        worker = threading.Thread(target=run, daemon=True)
        worker.start()
        worker.join(30.0)
        assert not worker.is_alive(), "build() did not return inside recording()"
    finally:
        cuda_build._LOADED.pop(key, None)
    assert out["lib"] is loaded
    assert out["seen"] == {lib_dir.name: str(lib_dir)}
