"""Reporting utilities: history files and plots."""

from mpc_code_tpu_torch.utils.io import load_history, save_history
from mpc_code_tpu_torch.utils.plotting import makeplot, plot_history

__all__ = ["makeplot", "plot_history", "save_history", "load_history"]
