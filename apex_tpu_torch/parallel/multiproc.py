"""Process-group bring-up and the multi-process launcher.

Counterpart of ``apex_tpu/parallel/multiproc.py``, with its arguments and
``APEX_TPU_*`` environment names. JAX drives every local chip from one
process and needs ``jax.distributed`` only across hosts; a PyTorch
collective always needs a process group, so with no coordinator
:func:`initialize_distributed` makes a one-process group on this machine
(a ``TCPStore`` on 127.0.0.1), which gives collectives at world size 1 a
group to run on. The backend is NCCL when the device is the card (the
default) and gloo when the caller asks for the CPU, unless the caller
names one: ranks that share one card must ask for gloo, since NCCL
refuses two ranks on one device.

Launcher, one invocation per process (e.g. from your scheduler)::

    python -m apex_tpu_torch.parallel.multiproc --nnodes 2 --node_rank $I \\
        --coordinator host0:1234 train.py --arg ...

It sets ``APEX_TPU_COORDINATOR``, ``APEX_TPU_NUM_PROCESSES`` and
``APEX_TPU_PROCESS_ID`` and runs the script, which calls
:func:`initialize_distributed` with no arguments.
"""

import os
import subprocess
import sys

import torch
import torch.distributed as dist

from apex_tpu_torch._device import resolve_device


def initialize_distributed(coordinator=None, num_processes=None,
                           process_id=None, *, device=None, backend=None):
    """Initialize the default ``torch.distributed`` process group from the
    arguments or the env this launcher sets (``coordinator`` is
    ``host:port`` of rank 0's store). ``device``: where this process's
    collectives run, the card unless the caller asks for the CPU.
    ``backend``: PyTorch's backend name; None takes NCCL on the card and
    gloo on the CPU. Returns the backend's name."""
    if coordinator is None:
        coordinator = os.environ.get("APEX_TPU_COORDINATOR")
    if num_processes is None:
        num_processes = os.environ.get("APEX_TPU_NUM_PROCESSES")
    if process_id is None:  # explicit 0 (rank 0) must win over the env
        process_id = os.environ.get("APEX_TPU_PROCESS_ID")
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    if coordinator is None:  # this process alone
        store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
        return backend
    if num_processes is None or process_id is None:
        raise ValueError(
            "initialize_distributed: num_processes and process_id are "
            "required when a coordinator is set (pass them or export "
            "APEX_TPU_NUM_PROCESSES / APEX_TPU_PROCESS_ID)")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return backend


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    nnodes, node_rank, coordinator = 1, 0, None
    while argv and argv[0].startswith("--"):
        flag = argv.pop(0)
        if flag in ("--nnodes", "--node_rank", "--coordinator") and not argv:
            raise SystemExit(f"{flag} requires a value")
        if flag == "--nnodes":
            nnodes = int(argv.pop(0))
        elif flag == "--node_rank":
            node_rank = int(argv.pop(0))
        elif flag == "--coordinator":
            coordinator = argv.pop(0)
        else:
            raise SystemExit(f"unknown flag {flag}")
    if not argv:
        raise SystemExit(
            "usage: multiproc [--nnodes N --node_rank I --coordinator "
            "host:port] script.py [args...]")
    env = dict(os.environ)
    if coordinator is not None:
        env["APEX_TPU_COORDINATOR"] = coordinator
        env["APEX_TPU_NUM_PROCESSES"] = str(nnodes)
        env["APEX_TPU_PROCESS_ID"] = str(node_rank)
    cmd = [sys.executable] + argv
    raise SystemExit(subprocess.call(cmd, env=env))


if __name__ == "__main__":
    main()
