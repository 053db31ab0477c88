"""The port's checkpointed closed loop and its two linear-model workloads, CPU.

- ``run_traced_checkpointed`` (JAX ``batched.py:532-602``) on ``lmpc_wb``
  (14 steps, N=10, segments of 5), as JAX's own
  ``tests/test_traced_fidelity.py::test_checkpointed_run_matches_and_resumes``:
  the segmented run equals ``run_traced`` (U, Yp, XS to 1e-10; measured
  0), and a resume from the checkpoint of the first segment reproduces the
  rest.  The checkpoint holds the carry field by field, the duals dict
  entry by entry, and is rewritten atomically.
- ``examples/lmpc_loop_workload.py`` at 8 lanes, N=6, 2 steps in f64: its
  lanes lie in their box and inside the state bounds, the loop runs with
  the Kalman filter and the structured OCP (nxa=5) and its history is
  finite.
- ``examples/closed_loop_bench.py`` at 16 lanes, 4 steps: the tool's two
  lines, every OCP solved, warm steps in fewer iterations than the cold
  one; ``small_cfg`` equals ``__graft_entry__._small_cfg`` field by field
  (the one test here that reads the JAX package).

About 10 s in one process on the CPU.
"""

import dataclasses as dc
import os

import numpy as np
import torch

torch.set_num_threads(1)


def test_checkpointed_run_matches_and_resumes(tmp_path):
    from mpc_code_tpu_torch.examples.lmpc_wb import make_config
    from mpc_code_tpu_torch.loop.batched import run_traced, run_traced_checkpointed

    cfg = make_config(Nsim=14).replace(N=10)
    path = str(tmp_path / "sweep.npz")
    _, H1 = run_traced(cfg, Nsim=14, device="cpu")
    _, H2 = run_traced_checkpointed(cfg, path, segment=5, Nsim=14, resume=False,
                                    device="cpu")
    assert set(H2) == set(H1)
    for key in ("U", "Yp", "XS"):
        assert np.abs(H2[key] - H1[key]).max() < 1e-10, key
    np.testing.assert_array_equal(H2["OCP_ITERS"], H1["OCP_ITERS"])
    with np.load(path) as z:
        assert int(z["__k_done__"]) == 14
        assert z["__carry_duals.lam__"].shape == (1, 10, 6)
    assert [f for f in os.listdir(tmp_path)] == ["sweep.npz"]

    # a kill after the first segment: the file holds segment 1 only; resume
    run_traced_checkpointed(cfg, path, segment=5, Nsim=5, resume=False, device="cpu")
    _, H3 = run_traced_checkpointed(cfg, path, segment=5, Nsim=14, resume=True,
                                    device="cpu")
    assert H3["U"].shape == H1["U"].shape
    for key in ("U", "Yp", "XS"):
        assert np.abs(H3[key] - H1[key]).max() < 1e-10, key


def test_lmpc_loop_workload_runs():
    from mpc_code_tpu_torch.examples import lmpc_loop_workload as lw

    x0s = lw.draw_x0(8, "cpu", dtype=torch.float64)
    assert ((x0s >= torch.as_tensor(lw.XLO)) & (x0s <= torch.as_tensor(lw.XHI))).all()
    cfg = lw.make_config(N=6)
    b = cfg.bounds
    assert ((x0s > torch.as_tensor(b.xmin)) & (x0s < torch.as_tensor(b.xmax))).all()
    H, times = lw.run_loop(cfg, x0s, Nsim=2, device="cpu", step=lw.make_step(cfg, "cpu"))
    assert H["U"].shape == (2, 8, 2) and len(times) == 2
    assert set(times[0]) == {"wall_s", *lw.PHASES}
    for k in ("U", "Xp", "X_HAT_CORR", "D_HAT"):
        assert np.isfinite(H[k]).all(), k
    assert (H["STATUS_SS"] == 0).all() and (H["STATUS_DYN"][0] == 0).all()


def test_closed_loop_bench_runs():
    from mpc_code_tpu_torch.examples import closed_loop_bench as cb

    lines, r = cb.run(batch=16, steps=4, max_it=10, device="cpu")
    assert lines[0].startswith("# compile=") and "platform=cpu" in lines[0]
    assert "ok=64/64" in lines[0]
    assert lines[1].startswith("closed-loop MPC steps/s/chip: ")
    assert r["status"].shape == (4, 16) and (r["status"] == 0).all()
    assert (r["iters"][1:] < r["iters"][0]).all()
    assert len(r["reps_s"]) == 3 and r["run_s"] == float(np.median(r["reps_s"]))


def test_small_cfg_is_the_graft_entry_config():
    import importlib.util

    from mpc_code_tpu_torch.examples.closed_loop_bench import small_cfg

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", os.path.join(root, "__graft_entry__.py"))
    ge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ge)
    ref, got = ge._small_cfg(N=20), small_cfg(N=20)

    def same(a, b):
        if dc.is_dataclass(a):
            return type(a).__name__ == type(b).__name__ and all(
                same(getattr(a, f.name), getattr(b, f.name)) for f in dc.fields(a))
        if a is None or isinstance(a, (bool, int, float, str)):
            return a == b
        if callable(a):
            return callable(b)
        return np.array_equal(np.asarray(a), np.asarray(b))

    assert same(ref, got)
