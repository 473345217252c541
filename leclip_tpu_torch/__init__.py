"""leclip_tpu_torch — the PyTorch / CUDA port of ``leclip_tpu`` for one
NVIDIA H100.

Same subpackage layout as ``leclip_tpu`` (models/, ops/, inference/,
engine/, data/, cli/), so each module's counterpart carries the same name.
The port imports torch, numpy and the standard library only; the JAX package
is its reference and is never imported here. Hand-written Hopper kernels live
in ``csrc/`` and are built with nvcc on first use into ``_build/``.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""

__version__ = "0.1.0"
