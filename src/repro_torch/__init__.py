"""PyTorch / CUDA port of the linear-time Sinkhorn package ``repro``.

The JAX package ``repro`` is the reference; this package does the same work
in PyTorch, with every TPU kernel on its path written by hand in CUDA C++
for Hopper (``kernels/csrc``). Its module layout mirrors ``repro``'s. It
imports ``torch`` and never ``jax`` or ``repro``. Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``, where
every kernel runs its plain PyTorch version.
"""
