"""PyTorch/CUDA port of the PagedEviction serving system.

The JAX package ``repro`` is the reference; this package imports nothing of
it (nor JAX). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the card the paged attention goes through the
hand-written kernels under ``csrc/``.
"""
