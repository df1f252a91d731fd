"""PyTorch/CUDA port of the SchedTwin digital twin (``repro``).

Mirrors ``repro``'s layout: ``core/`` and ``cluster/`` (the twin),
``configs/``, ``models/`` and ``serve/`` (the LM serving stack),
``kernels/`` with their CUDA sources in ``csrc/``, and ``launch/`` (the
CLIs).  Imports torch, numpy and the standard library only; the JAX
package is the reference the port's tests hold it against.
"""
