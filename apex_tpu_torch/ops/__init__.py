"""Functional entry points over the kernels."""
