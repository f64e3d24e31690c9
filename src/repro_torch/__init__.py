"""PyTorch and CUDA port of the instruction-graph runtime (``src/repro``).

``repro_torch.core`` is the runtime, ``repro_torch.kernels`` the hand-written
Hopper kernels with their plain PyTorch versions, and ``repro_torch.apps`` the
paper's applications on the port.  The package imports neither JAX nor
``repro``.
"""
