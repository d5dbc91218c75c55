"""repro_torch — the PyTorch/CUDA port of the ABC-FHE client (``repro``).

The JAX package ``repro`` is the reference; this package imports ``torch``
and numpy only, never ``jax`` and never a ``repro`` module. Slice 1 ports the
default ``FHEClient`` path: df32 encode+encrypt and decrypt+decode, with the
two streaming megakernels hand-written in CUDA for Hopper
(``repro_torch.kernels.csrc``) and a plain PyTorch version of each beside it.
Importing the package builds nothing and touches no device.
"""

__version__ = "0.1.0"
