"""PyTorch/CUDA port of the log-structured serving system (``repro``).

The package mirrors the layout of the JAX package — ``configs``, ``core``,
``models``, ``kernels``, ``serving`` — and imports nothing of it: where it
needs a framework-free module it keeps its own copy.  Its kernels are
hand-written CUDA for Hopper (``sm_90a``); entry points run on the CUDA card
unless the caller passes ``device="cpu"``, which runs the plain PyTorch
version of every kernel.
"""
