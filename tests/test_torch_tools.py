"""The port's command-line tools and entry points, one small CPU run each:
``examples/weak_scaling.py --cpu`` at one rank, ``examples/latency_report.py``
on lmpc_wb for 2 steps, ``examples/profile_phases.py --cpu`` at B=8, N=5
(both CSTR tools with RK4 at 2 sub-steps and a cap of 5 iterations),
``examples/closed_loop_bench.py`` at B=8 for 2 steps with its AOT key, and
``entry.py``'s step and one-rank dry run."""

import json
import os

import numpy as np
import torch

torch.set_num_threads(1)


def test_weak_scaling_one_rank_on_the_cpu(capsys):
    import torch.distributed as dist

    from mpc_code_tpu_torch.examples import weak_scaling

    rows = weak_scaling.main(["--cpu", "--per-device", "2", "--n", "5", "--reps", "1",
                             "--mx", "2", "--max-iter", "5"])
    assert not dist.is_initialized()
    assert len(rows) == 1 and rows[0]["devices"] == 1 and rows[0]["batch"] == 2
    assert rows[0]["weak_scaling_eff"] == 1.0 and rows[0]["solves_per_s"] > 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert json.loads(lines[-1]) == rows[0]


def test_latency_report_on_lmpc_wb():
    from mpc_code_tpu_torch.examples import latency_report

    lines = latency_report.report("lmpc_wb", 2, device="cpu")
    assert [ln.split(":")[0] for ln in lines] == ["lmpc_wb target", "lmpc_wb OCP"]
    assert all("p50=" in ln and "p99=" in ln and "h=1.0s" in ln for ln in lines)


def test_profile_phases_on_the_cpu(tmp_path, capsys):
    from mpc_code_tpu_torch.examples import profile_phases

    rows = profile_phases.main(["--cpu", "--batch", "8", "--n", "5", "--reps", "1",
                                "--k", "1", "--mx", "2", "--max-iter", "5",
                                "--trace", str(tmp_path)])
    assert [r["phase"] for r in rows] == ["deriv_sweep(solver path)", "riccati_kkt",
                                         "residuals", "merit_eval", "full_solve"]
    assert all(r["ms_per_batch"] > 0 for r in rows)
    assert rows[-1]["fraction_of_iter"] is None
    assert os.path.exists(tmp_path / "solve_trace.json")
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert out == rows


def test_closed_loop_bench_with_its_aot_key(tmp_path, monkeypatch):
    from mpc_code_tpu_torch.examples import closed_loop_bench as cb

    monkeypatch.setenv("MPC_TPU_AOT_CACHE", str(tmp_path))
    lines, r = cb.run(batch=8, steps=2, max_it=10, device="cpu")
    assert "ok=16/16" in lines[0] and "platform=cpu" in lines[0]
    assert r["status"].shape == (2, 8)
    arts = [p for p in os.listdir(tmp_path) if os.path.isdir(tmp_path / p)]
    assert len(arts) == 1
    with open(tmp_path / arts[0] / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["key"].startswith(f"closed_loop|{cb.aot_key(10)}|steps=2")
    assert manifest["libraries"] == []          # no kernel library on the CPU


def test_entry_step_and_one_rank_dry_run():
    import torch.distributed as dist

    from mpc_code_tpu_torch import entry

    fn, (carry,) = entry.entry(device="cpu")
    x, u, st = fn(carry)
    assert x.shape == (4, 3) and u.shape == (4, 2) and (st == 0).all()
    try:
        lin, mhe = entry.dryrun_multichip(1, device="cpu")
    finally:
        dist.destroy_process_group()
    assert lin[1].u.shape == (1, 2, 2) and mhe[1].u.shape == (1, 2, 1)
    for _, out in (lin, mhe):
        assert np.isfinite(out.u.numpy()).all() and (out.status_dyn != 2).all()
