"""Parallelism utilities. So far: the int8 block core of
:mod:`~apex_tpu_torch.parallel.compression`."""
