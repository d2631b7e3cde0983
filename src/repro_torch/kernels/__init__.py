"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``), their ``ctypes``
launchers, their plain PyTorch versions (``ref.py``), the routed public
wrappers (``ops.py``), the kernel registry (``registry.py``) and the
autotuner with Hopper's cost model (``autotune.py``)."""
