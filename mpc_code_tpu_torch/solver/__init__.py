"""Batched NLP solvers (PyTorch port): the dense primal-dual interior point
(``solver/ipm.py``) and the structured Riccati IPM (``solver/riccati.py``)."""

from mpc_code_tpu_torch.solver.nlp import IPMResult, NLP, NLPBounds
from mpc_code_tpu_torch.solver.ipm import kkt_error, make_solver

__all__ = ["NLP", "NLPBounds", "IPMResult", "make_solver", "kkt_error"]
