"""The JAX package's five example scripts, ported: each runs as
``python -m repro_torch.examples.<name>`` (``--device cpu`` for the plain
kernel versions, default CUDA) and has a ``main(argv=None, ...) -> dict``
returning what it prints."""
