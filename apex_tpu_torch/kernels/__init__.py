"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version, and their build (:mod:`._build`) and launch counters
(:mod:`.registry`)."""
