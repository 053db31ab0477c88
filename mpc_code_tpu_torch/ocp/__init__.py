"""The port's problem transcriptions: the dense shooting OCP (``ocp/shooting.py``),
the dense Gauss-Legendre collocation OCP (``ocp/collocation.py``), the
steady-state target (``ocp/target.py``) and the MHE window NLP in its
dense and structured forms (``ocp/mhe.py``)."""

from mpc_code_tpu_torch.ocp.shooting import OCPSpec, build_ocp
from mpc_code_tpu_torch.ocp.target import (
    TargetSpec, build_ss_id, build_ssp, build_ssp2, build_target,
)

__all__ = ["build_ocp", "OCPSpec", "build_target", "build_ssp", "build_ssp2",
           "build_ss_id", "TargetSpec"]
