"""PyTorch/CUDA port of the EF21-SGDM system in ``src/repro``.

The JAX package is the reference; this package keeps its module names so
each counterpart is easy to find, imports ``torch`` and numpy only, and runs
its hand-written CUDA kernels (``kernels/csrc``) on an NVIDIA Hopper card.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
where every kernel wrapper runs its plain PyTorch version instead.
"""
