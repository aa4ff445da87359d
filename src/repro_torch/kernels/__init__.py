"""Paged attention kernels (hand-written CUDA under ``csrc/``), their plain
torch versions, and the wrappers the model calls (``ops``)."""
