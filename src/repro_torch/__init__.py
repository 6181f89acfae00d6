"""PyTorch port of the ``repro`` JAX package, for one NVIDIA H100.

The layout mirrors ``src/repro/`` module for module, so each file's
counterpart is found by name. The JAX package stays the reference: the
``tests/test_torch_*.py`` files hold this package to it on the CPU. This
package imports ``torch`` and never ``jax``, nor anything of ``repro``.

Ported so far: the training, prefill and decode steps of all ten archs
with both kernels, the training driver in full (checkpoints, six
optimizers, async SGD, gradient compression), the serve driver, the
sharding layer (rules, meshes, sharded steps, the elastic restore), and
the predictor's GPU path (DES, FLOP count, step DAG, what-if).
"""
