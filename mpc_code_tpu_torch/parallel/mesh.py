"""Device meshes, batch sharding and the sharded batched closed loop on ``torch.distributed``.

Port of ``mpc_code_tpu/parallel/mesh.py``.  The scaling axis is the same:
batch (data) parallelism over independent MPC scenarios, each scenario's
solve chain independent, so every rank runs its own block of lanes with
no communication inside the solve; collectives appear only for metric
aggregation.  The mapping:

- a JAX ``Mesh`` over devices is a 1-D ``DeviceMesh`` named ``(axis,)``
  with one rank per device: ``cuda:LOCAL_RANK`` under NCCL, or the CPU
  under gloo;
- ``NamedSharding(P('batch'))``: each rank holds a contiguous block of
  the leading axis (``shard_batch``), and a runner's outputs are that
  rank's block, ``(n_steps, B_local, ...)``;
- ``jax.distributed.initialize`` is ``init_process_group``
  (``init_distributed``), and ``psum`` / ``pmax`` are ``all_reduce``
  with SUM and MAX (``aggregate_metrics``).

Per-lane math is unchanged: every reduction of the step is per lane, so a
sharded run equals the unsharded one lane for lane.  Launch several ranks
with ``torchrun --nproc-per-node N`` (``init_distributed()`` then reads
its environment) or with explicit addresses, as
``examples/weak_scaling.py --distributed`` does.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from mpc_code_tpu_torch.config import MPCConfig
from mpc_code_tpu_torch.device import resolve_device

# a rendezvous or collective that waits longer fails the run instead of
# hanging it (a lost rank)
DEFAULT_TIMEOUT_S = 120.0


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device=None,
                     timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group (no-op if one already exists).

    JAX's keywords map over: ``coordinator_address`` ("host:port") is the
    ``tcp://`` rendezvous, ``num_processes`` the world size and
    ``process_id`` the rank.  Without them the group is read from the
    environment as ``torchrun`` sets it (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``).  The backend is NCCL on the card (``device``
    default) and gloo for ``device="cpu"``; a rank waits at most
    ``timeout`` seconds for the others, at the rendezvous and in every
    collective."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    kw = dict(backend=_backend(dev), timeout=datetime.timedelta(seconds=timeout))
    if coordinator_address is not None:
        kw.update(init_method=f"tcp://{coordinator_address}",
                  world_size=int(num_processes if num_processes is not None else 1),
                  rank=int(process_id if process_id is not None else 0))
    else:
        kw.update(init_method="env://")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", kw.get("rank", os.environ.get("RANK", 0))))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(**kw)


def make_mesh(n_devices: Optional[int] = None, axis: str = "batch", device=None):
    """A 1-D ``DeviceMesh`` named ``(axis,)`` over ranks ``0 .. n - 1`` of
    the process group (``n`` = every rank by default).  With no process
    group and ``n_devices`` in (None, 1) it first creates a one-rank group
    on a free 127.0.0.1 port, so that ``make_mesh(1)`` works in a plain
    process.  Ranks outside a smaller mesh take part in its creation and
    hold no block of it."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"make_mesh({n_devices}) needs a process group of "
                             f"{n_devices} ranks: call init_distributed first")
        init_distributed(coordinator_address=f"127.0.0.1:{_free_port()}",
                         num_processes=1, process_id=0, device=dev)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks does not fit a world of {world}")
    return DeviceMesh(dev.type, list(range(n)), mesh_dim_names=(axis,))


def mesh_device(mesh) -> torch.device:
    """This rank's device in ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(tree, mesh, axis: str = "batch"):
    """This rank's contiguous block of every leaf's leading axis, on its
    device (JAX ``device_put`` with ``P(axis)``).  A batch that the mesh's
    ranks do not divide raises ``ValueError``, as JAX's ``device_put``
    does."""
    n = mesh.size()
    r = mesh.get_local_rank(axis)
    dev = mesh_device(mesh)

    def block(x):
        x = torch.as_tensor(x)
        B = x.shape[0]
        if B % n:
            raise ValueError(f"a batch of {B} lanes does not split over {n} ranks")
        b = B // n
        return x[r * b:(r + 1) * b].to(dev)

    return _map(block, tree)


def make_closed_loop_runner(cfg: MPCConfig, n_steps: int, batch: int, mesh=None,
                            ysp=None, usp=None, xsp=None, aot_key: Optional[str] = None,
                            device=None, dtype=None):
    """Build a REUSABLE closed-loop runner: ``runner(x0_batch, inputs=None)
    -> (final_carry, outputs)``.

    ``x0_batch`` is the GLOBAL batch (B, nx), as in JAX; the step
    (``make_mpc_step``, built once) runs ``n_steps`` times, and the outputs
    are stacked ``(n_steps, B, ...)`` (``loop/batched.py::stack_outputs``).
    Under a ``mesh`` each rank steps its own block and returns it: the
    carry and outputs are ``B / n`` lanes, on the rank's device.  Calls may
    supply a ``StepInput`` stack (leading ``(n_steps,)`` axis from
    ``make_step_inputs``), which every rank reads whole (replicated).

    ``aot_key``: the kernel-library artifact cache (``utils/aot.py``).
    ``"auto"`` derives the key from the content hash of the config and
    setpoints, so two processes building the same config share the
    artifact and any one-field change misses; an explicit string must
    identify the config.  At construction the runner then loads the
    artifact's libraries, or on a miss runs once on ``batch`` lanes at
    ``cfg.x0_p`` in ``dtype`` (default f64) to build and save them; its
    calls take x0 of that shape and dtype.
    Only the unsharded runner without inputs supports it, as in JAX.
    ``batch`` is the batch hint of the step (the sweep autotune's, per
    rank under a mesh).
    """
    from mpc_code_tpu_torch.loop.batched import init_carry, make_mpc_step, stack_outputs
    from mpc_code_tpu_torch.loop.schedules import StepInput

    if aot_key is not None and mesh is not None:
        raise ValueError("aot_key supports the unsharded runner only")
    dev = mesh_device(mesh) if mesh is not None else resolve_device(device)
    n_rank = mesh.size() if mesh is not None else 1
    step = make_mpc_step(cfg, ysp=ysp, usp=usp, xsp=xsp, device=dev,
                         batch_hint=max(int(batch) // n_rank, 1))

    def run(carry, inputs=None):
        outs = []
        for k in range(n_steps):
            inp = None if inputs is None else StepInput(*(a[k] for a in inputs))
            carry, out = step(carry, inp)
            outs.append(out)
        return carry, stack_outputs(outs)

    def replicate(inputs):
        return None if inputs is None else StepInput(
            *(None if a is None else torch.as_tensor(a, device=dev) for a in inputs))

    def init_b(x0):
        return init_carry(cfg, torch.as_tensor(x0, device=dev), device=dev)

    if aot_key is not None:
        from mpc_code_tpu_torch.utils.aot import content_hash, export_cached

        if aot_key == "auto":
            aot_key = content_hash(cfg, ysp, usp, xsp)
        fdt = torch.float64 if dtype is None else dtype
        x0_tpl = torch.as_tensor(np.tile(np.asarray(cfg.x0_p, float), (int(batch), 1)),
                                 dtype=fdt, device=dev)
        run_aot = export_cached(lambda carry: run(carry, None),
                                f"closed_loop|{aot_key}|steps={n_steps}", (init_b(x0_tpl),))

        def runner(x0_batch, inputs=None):
            if inputs is not None:
                raise ValueError("the AOT runner is exported without a "
                                 "StepInput stack; build it with the input "
                                 "shapes instead (aot_key=None)")
            x0 = torch.as_tensor(x0_batch, device=dev)
            if x0.dtype != fdt or tuple(x0.shape) != (int(batch), cfg.nx):
                raise ValueError(f"the AOT runner was exported for x0 of shape "
                                 f"{(int(batch), cfg.nx)} in {fdt}; got "
                                 f"{tuple(x0.shape)} in {x0.dtype}")
            return run_aot(init_b(x0))

        return runner

    if mesh is not None:
        def runner(x0_batch, inputs=None):
            return run(init_b(shard_batch(x0_batch, mesh)), replicate(inputs))
    else:
        def runner(x0_batch, inputs=None):
            return run(init_b(x0_batch), replicate(inputs))

    return runner


def batched_closed_loop(cfg: MPCConfig, x0_batch, n_steps: int, mesh=None, ysp=None,
                        usp=None, xsp=None, inputs=None, device=None):
    """Run ``n_steps`` of the full MPC loop for a batch of initial states,
    optionally sharded over a mesh; ``inputs`` is an optional ``StepInput``
    stack shared by every lane.  Returns (final_carry, outputs) with
    outputs leaves shaped (n_steps, B, ...) (this rank's block under a
    mesh).  One-shot convenience wrapper: every call rebuilds the step;
    for repeated runs build a :func:`make_closed_loop_runner` once."""
    x0 = torch.as_tensor(x0_batch)
    runner = make_closed_loop_runner(cfg, n_steps, int(x0.shape[0]), mesh=mesh, ysp=ysp,
                                     usp=usp, xsp=xsp, device=device)
    return runner(x0, inputs)


def aggregate_metrics(statuses, iters, mesh, axis: str = "batch") -> dict:
    """Cross-rank reduction of per-lane solve metrics (JAX's shard_map +
    psum/pmax): ``statuses``/``iters`` are this rank's block.  Returns
    {n_ok, n_total, max_iters, sum_iters}, equal on every rank of the
    mesh, so any rank can read it without a gather."""
    dev = mesh_device(mesh)
    st = torch.as_tensor(statuses, device=dev).reshape(-1)
    it = torch.as_tensor(iters, device=dev).reshape(-1).to(torch.int64)
    sums = torch.stack([(st != 2).sum(), torch.tensor(st.numel(), device=dev),
                        it.sum()]).to(torch.int64)
    mx = (it.max() if it.numel() else torch.zeros((), dtype=torch.int64, device=dev))
    mx = torch.clamp(mx, min=0).reshape(1)
    group = mesh.get_group(axis)
    dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
    return dict(n_ok=int(sums[0]), n_total=int(sums[1]), max_iters=int(mx[0]),
                sum_iters=int(sums[2]))
