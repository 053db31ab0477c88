"""Problem builders of the port (``ocp/target.py``)."""
