"""Example configurations (PyTorch port).

Each of ``lmpc_wb``, ``lmpc_cstr``, ``lmpc_nlplant``, ``lmpcxp_nlplant``,
``nmpc``, ``nmpc_dis`` and ``enmpc`` exposes ``make_config() -> MPCConfig``
mirroring the matching ``Ex_*.py`` file of the reference; ``python -m
mpc_code_tpu_torch.examples <name>`` runs one through the host loop.  The
``*_workload.py`` modules drive the batched paths on the card.
"""

from mpc_code_tpu_torch.examples import lmpc_wb

__all__ = ["lmpc_wb"]
