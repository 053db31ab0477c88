"""Closed-loop runtime: the batched step (``loop/batched.py``) and its
schedules (``loop/schedules.py``).  The host-driven ``ClosedLoop`` is not
ported yet (ROADMAP Queue 1 item 22)."""
