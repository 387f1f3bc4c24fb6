"""PyTorch/CUDA port of the lossless homomorphic compression system.

A second, self-contained package beside the JAX reference (``repro``).
Subpackages mirror the reference's names (``core``, ``kernels``, ``net``,
``ft``, ``models``, ``train``, ``data``, ``configs``, ``launch``) so each
module's counterpart is found by name. The port imports ``torch`` and ``numpy``
only; the hand-written CUDA kernels of the wire codec live under
``kernels/csrc`` and are built on first use on a CUDA device.

Entry points default to ``device="cuda"``; pass ``device="cpu"`` to run
the plain PyTorch versions (the CPU tests do).
"""
