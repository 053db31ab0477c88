"""Scale-out on ``torch.distributed``: device meshes, batch sharding, multi-process init."""

from mpc_code_tpu_torch.parallel.mesh import (
    batched_closed_loop,
    init_distributed,
    make_closed_loop_runner,
    make_mesh,
    shard_batch,
)

__all__ = ["make_mesh", "shard_batch", "batched_closed_loop", "make_closed_loop_runner",
           "init_distributed"]
