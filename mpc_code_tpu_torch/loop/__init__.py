"""Closed-loop runtime: the per-sample host loop ``ClosedLoop``
(``loop/simulator.py``), the batched step (``loop/batched.py``) and its
schedules (``loop/schedules.py``)."""

from mpc_code_tpu_torch.loop.simulator import ClosedLoop

__all__ = ["ClosedLoop"]
