"""blade_torch: the PyTorch / CUDA port of BLADE for one NVIDIA H100.

Mirrors ``blade/``'s module tree (``blade/x/y.py`` -> ``blade_torch/x/y.py``).
Imports ``torch`` only, never ``jax`` or ``blade``.  The hand-written Hopper
kernels live in ``csrc/`` and are built on first use by
``kernels/_build.py``.
"""

__version__ = "0.1.0"
