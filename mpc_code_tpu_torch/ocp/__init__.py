"""The port's problem transcriptions: the dense shooting OCP (``ocp/shooting.py``),
the dense Gauss-Legendre collocation OCP (``ocp/collocation.py``), the
steady-state target (``ocp/target.py``) and the MHE window NLP in its
dense and structured forms (``ocp/mhe.py``)."""
