"""Bottleneck text adapter, the ``Caption_distill_double_adapter`` variant
(counterpart of leclip_tpu/models/adapter.py; ref: project/my_code/trainers/
Caption_distill_double_adapter.py:84-127,305-322,463-627): a 2-layer
bias-free bottleneck MLP (width → width/reduction → width, ReLU after both)
applied as a residual over the transformer output BEFORE ln_final, and only
on the PROMPT encoding path (captions go through the plain text tower).

The reference freezes everything outside "prompt_learner", so its adapter
stays at random init; here the adapter params live in their own tree and
``adapter_trainable`` opts them into the optimizer."""

from __future__ import annotations

import torch


def init_adapter_params(generator: torch.Generator, width: int, reduction: int = 4,
                        dtype=torch.float32, device=None) -> dict:
    """He-scaled normal kernels, ``down_kernel`` [width, hidden] and
    ``up_kernel`` [hidden, width] ([in, out], the JAX layout), drawn from
    ``generator`` (the JAX package draws its own from a PRNG key; tests
    carry those across)."""
    hidden = width // reduction

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=device) * std).to(dtype)

    return {"down_kernel": normal((width, hidden), (2.0 / width) ** 0.5),
            "up_kernel": normal((hidden, width), (2.0 / hidden) ** 0.5)}


def apply_adapter(x: torch.Tensor, params: dict) -> torch.Tensor:
    """relu(relu(x @ down) @ up), the bottleneck transform (no residual;
    callers add it)."""
    h = torch.relu(x @ params["down_kernel"].to(x.dtype))
    return torch.relu(h @ params["up_kernel"].to(x.dtype))
