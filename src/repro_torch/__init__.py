"""PyTorch/CUDA port of the SchedTwin digital twin (``repro``).

Mirrors ``repro``'s layout (``core/``, ``cluster/``, ``kernels/``,
``launch/``).  Imports torch, numpy and the standard library only; the
JAX package is the reference the port's tests hold it against.
"""
