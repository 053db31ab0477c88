"""The port's ``parallel/mesh.py`` on ``torch.distributed``: two gloo ranks
over 127.0.0.1 against the unsharded run and the JAX package's.

Two child processes (this file run as a script, one per rank) join a gloo
group, split the batch over a 2-rank mesh and write their blocks; the
test process holds the concatenated blocks against the port's unsharded
run to 1e-10 (JAX's bar, ``tests/test_parallel.py:46``) and against
JAX's ``batched_closed_loop(mesh=None)`` on ``test_parallel.py:44-45``'s
call to 1e-8.  The children also run the nmpc family with
``make_step_inputs`` (``test_parallel.py:51-85``, RK4 at 2 sub-steps), reduce
``test_parallel.py:111-124``'s 64 lanes with ``aggregate_metrics``, check
that a second ``init_distributed`` is a no-op and that a batch of 7 lanes
raises.  A rank whose peer never comes fails within its timeout.  The
one-rank mesh of a plain process is tested in process.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YSP = np.array([0.2, 0.0, 0.0])
B = 8
CHILD_TIMEOUT_S = 60.0        # the gloo group's rendezvous and collectives
WAIT_S = 240                  # a child's whole run


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _lin_cfg():
    from mpc_code_tpu_torch.examples.closed_loop_bench import small_cfg

    return small_cfg(N=4)


def _lin_x0(cfg):
    return np.tile(np.asarray(cfg.x0_p, float), (B, 1)) + 0.1 * np.arange(B)[:, None]


def _nmpc_cfg():
    """``test_parallel.py:69``'s config with its RK4 cut to 2 sub-steps
    (the same code path at a third of the CPU time)."""
    import dataclasses as dc

    from mpc_code_tpu_torch.examples.nmpc import make_config

    cfg = make_config(Nsim=3).replace(N=6)
    return cfg.replace(model=dc.replace(cfg.model, Mx=2), plant=dc.replace(cfg.plant, Mx=2))


def _nmpc_x0(cfg):
    return np.tile(np.asarray(cfg.x0_p, float), (B, 1)) * (
        1.0 + 0.01 * np.linspace(0, 1, B)[:, None])


def _metric_lanes():
    rng = np.random.default_rng(0)
    st = rng.integers(0, 3, size=64).astype(np.int32)
    it = rng.integers(1, 40, size=64).astype(np.int32)
    return st, it


NMPC_FIELDS = ("u", "status_dyn", "xhat", "dhat")


def child(rank, port, outdir):
    """One rank of the two-rank run: its blocks into ``rank<r>.npz``."""
    import torch.distributed as dist

    from mpc_code_tpu_torch.loop.schedules import make_step_inputs
    from mpc_code_tpu_torch.parallel import mesh as pm

    pm.init_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                        process_id=rank, device="cpu", timeout=CHILD_TIMEOUT_S)
    group = dist.group.WORLD
    # a second call is a no-op, whatever it asks for
    pm.init_distributed(coordinator_address="127.0.0.1:1", num_processes=5,
                        process_id=3, device="cpu")
    out = dict(same_group=dist.group.WORLD is group, world=dist.get_world_size())
    mesh = pm.make_mesh(2, device="cpu")

    cfg = _lin_cfg()
    _, o = pm.batched_closed_loop(cfg, _lin_x0(cfg), 2, mesh=mesh, ysp=YSP)
    out.update(lin_u=o.u.numpy(), lin_status=o.status_dyn.numpy())

    ncfg = _nmpc_cfg()
    runner = pm.make_closed_loop_runner(ncfg, 3, B, mesh=mesh)
    _, o = runner(_nmpc_x0(ncfg), make_step_inputs(ncfg, 3))
    out.update({f"nmpc_{f}": getattr(o, f).numpy() for f in NMPC_FIELDS})

    st, it = _metric_lanes()
    h = len(st) // 2
    agg = pm.aggregate_metrics(st[rank * h:(rank + 1) * h], it[rank * h:(rank + 1) * h], mesh)
    out.update({f"agg_{k}": v for k, v in agg.items()})
    try:
        pm.shard_batch(np.zeros((7, 3)), mesh)
        out["odd_raised"] = False
    except ValueError:
        out["odd_raised"] = True
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


def lost_rank(port):
    """Rank 0 of a world of two whose rank 1 never comes: must fail."""
    from mpc_code_tpu_torch.parallel import mesh as pm

    pm.init_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                        process_id=0, device="cpu", timeout=1.0)


def _spawn(*args):
    env = dict(os.environ)
    for k in ("PYTHONPATH", "JAX_PLATFORMS"):
        env.pop(k, None)
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), *map(str, args)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                            text=True, cwd=ROOT)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("mesh")
    port = _free_port()
    procs = [_spawn(r, port, outdir) for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=WAIT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return [dict(np.load(os.path.join(outdir, f"rank{r}.npz"))) for r in range(2)]


def _cat(ranks, key):
    # the blocks sit on the lane axis, after the (steps,) axis
    return np.concatenate([r[key] for r in ranks], axis=1)


def test_two_gloo_ranks_equal_the_unsharded_run_and_jax(ranks):
    import jax

    from mpc_code_tpu.parallel import batched_closed_loop as j_loop
    from mpc_code_tpu_torch.parallel import batched_closed_loop

    cfg = _lin_cfg()
    x0s = _lin_x0(cfg)
    _, ref = batched_closed_loop(cfg, x0s, 2, ysp=YSP, device="cpu")
    u = _cat(ranks, "lin_u")
    assert u.shape == (2, B, cfg.nu)
    np.testing.assert_array_equal(_cat(ranks, "lin_status"), ref.status_dyn.numpy())
    assert np.abs(u - ref.u.numpy()).max() <= 1e-10

    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", os.path.join(ROOT, "__graft_entry__.py"))
    ge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ge)
    _, out_j = j_loop(ge._small_cfg(N=4), x0s, n_steps=2, mesh=None, ysp=YSP)
    assert jax.config.jax_enable_x64
    np.testing.assert_array_equal(_cat(ranks, "lin_status"), np.asarray(out_j.status_dyn))
    assert np.abs(u - np.asarray(out_j.u)).max() <= 1e-8


def test_two_gloo_ranks_nmpc_family(ranks):
    from mpc_code_tpu_torch.loop.schedules import make_step_inputs
    from mpc_code_tpu_torch.parallel import make_closed_loop_runner

    cfg = _nmpc_cfg()
    _, ref = make_closed_loop_runner(cfg, 3, B, device="cpu")(
        _nmpc_x0(cfg), make_step_inputs(cfg, 3))
    assert (ref.status_dyn.numpy() != 2).all()
    for f in NMPC_FIELDS:
        got, want = _cat(ranks, f"nmpc_{f}"), getattr(ref, f).numpy()
        assert got.shape == want.shape, f
        assert np.abs(got - want).max() <= 1e-10, f


def test_aggregate_metrics_over_two_ranks(ranks):
    st, it = _metric_lanes()
    want = dict(n_ok=int((st != 2).sum()), n_total=64, max_iters=int(it.max()),
                sum_iters=int(it.sum()))
    for r in ranks:
        assert {k: int(r[f"agg_{k}"]) for k in want} == want


def test_second_init_is_a_noop_and_odd_batch_raises(ranks):
    for r in ranks:
        assert bool(r["same_group"]) and int(r["world"]) == 2
        assert bool(r["odd_raised"])


def test_lost_rank_fails_within_its_timeout():
    t0 = time.perf_counter()
    p = _spawn("lost", _free_port())
    try:
        out, _ = p.communicate(timeout=WAIT_S)
    except subprocess.TimeoutExpired:
        p.kill()
        raise
    assert p.returncode != 0, out
    assert time.perf_counter() - t0 < 60


def test_one_rank_mesh_in_a_plain_process_runner_reuse_and_one_shot():
    """``make_mesh(1)`` with no group creates a one-rank group; the runner
    is reused across calls, and equals the one-shot wrapper
    (``test_parallel.py:127-141``)."""
    import torch.distributed as dist

    from mpc_code_tpu_torch.parallel import (
        batched_closed_loop, make_closed_loop_runner, make_mesh,
    )
    from mpc_code_tpu_torch.parallel.mesh import aggregate_metrics

    assert not dist.is_initialized()
    mesh = make_mesh(1, device="cpu")
    try:
        assert dist.get_world_size() == 1 and mesh.size() == 1
        with pytest.raises(ValueError, match="does not fit"):
            make_mesh(2, device="cpu")
        cfg = _lin_cfg()
        x0s = _lin_x0(cfg)[:4]
        _, ref = batched_closed_loop(cfg, x0s, 2, ysp=YSP, device="cpu")
        runner = make_closed_loop_runner(cfg, 2, 4, ysp=YSP, device="cpu")
        _, o1 = runner(x0s)
        _, o2 = runner(x0s + 1e-6)
        np.testing.assert_array_equal(o1.u.numpy(), ref.u.numpy())
        assert not np.array_equal(o2.u.numpy(), o1.u.numpy())
        _, om = make_closed_loop_runner(cfg, 2, 4, mesh=mesh, ysp=YSP)(x0s)
        np.testing.assert_array_equal(om.u.numpy(), ref.u.numpy())
        agg = aggregate_metrics(om.status_dyn, om.ocp_iters, mesh)
        assert agg == dict(n_ok=int((om.status_dyn != 2).sum()), n_total=8,
                           max_iters=int(om.ocp_iters.max()),
                           sum_iters=int(om.ocp_iters.sum()))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    if sys.argv[1] == "lost":
        lost_rank(int(sys.argv[2]))
    else:
        child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
