"""Numerical building blocks: integrators, small linear algebra, kernels."""
