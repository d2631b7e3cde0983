"""The Hydra broker ported to PyTorch, with hand-written CUDA and Triton kernels.

Counterpart of the JAX package ``repro``: each module here mirrors the
reference module of the same path and is held against it by the
``tests/test_torch_*.py`` suite.  Entry points run on a CUDA device unless
the caller asks for the CPU (``Hydra(device="cpu")``), where every kernel
wrapper runs its plain PyTorch version.
"""
