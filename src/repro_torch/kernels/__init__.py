"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``, Triton in the modules),
their launchers, their plain PyTorch versions (``ref.py``), the routed public
wrappers (``ops.py``) and the kernel registry (``registry.py``)."""
