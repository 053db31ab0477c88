"""Problem builders of the port: the dense shooting OCP (``ocp/shooting.py``)
and the steady-state target (``ocp/target.py``)."""
