"""Contributed kernels: the GQA decode attention."""
