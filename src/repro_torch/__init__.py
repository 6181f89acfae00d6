"""PyTorch port of the ``repro`` JAX package, for one NVIDIA H100.

The layout mirrors ``src/repro/`` module for module, so each file's
counterpart is found by name. The JAX package stays the reference: the
``tests/test_torch_*.py`` files hold this package to it on the CPU. This
package imports ``torch`` and never ``jax``, nor anything of ``repro``.

Ported so far: the dense training step (configs, layers, transformer,
flash-attention kernel, optimizers, synthetic data, train entry point).
"""
