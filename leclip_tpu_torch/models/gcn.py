"""Graph-convolution head over per-class features (counterpart of
leclip_tpu/models/gcn.py): the reference's GC_module / GraphConvolution, a
1- or 2-layer GCN that mixes per-class features through a learnable class
adjacency.

Parameters are a plain dict (``{"layers": [{"weight", "A"[, "bias"]}, ...]
[, "adj"]}``), the JAX package's tree; ``from_jax_params`` carries it
across. The adjacency seed is the reference's near-identity prior
eye·(1 − 0.001·C) + 0.001 per layer, or, with ``init_prob``, a thresholded
co-occurrence matrix shared by the layers. The forward is
adj @ (x @ W) (+ bias) per layer, LeakyReLU(0.15) between two layers,
batched over any leading axes."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _near_identity_prior(n_cls: int, device=None) -> torch.Tensor:
    return torch.eye(n_cls, device=device) * (1.0 - 0.001 * n_cls) + 0.001


def init_gcn_params(generator: torch.Generator, n_cls: int, dim: int = 1024, layers: int = 1,
                    count_prob: Optional[np.ndarray] = None, init_prob: bool = False,
                    threshold: float = 0.3, bias: bool = False, device=None) -> dict:
    """GC_module parameters: per layer a weight uniform in ±dim^-½ and the
    near-identity adjacency (and a bias with ``bias``); with ``init_prob``
    the shared learnable adjacency ``count_prob`` with entries below
    ``threshold`` zeroed."""
    if layers not in (1, 2):
        raise ValueError(f"GC_module supports 1 or 2 layers, got {layers}")
    stdv = 1.0 / math.sqrt(dim)

    def uniform(shape):
        return (torch.rand(shape, generator=generator, device=device) * 2 - 1) * stdv

    params = {"layers": []}
    for _ in range(layers):
        layer = {"weight": uniform((dim, dim)), "A": _near_identity_prior(n_cls, device)}
        if bias:
            layer["bias"] = uniform((1, 1, dim))
        params["layers"].append(layer)
    if init_prob:
        if count_prob is None:
            raise ValueError("init_prob=True requires count_prob")
        cp = torch.as_tensor(np.asarray(count_prob, np.float32), device=device)
        params["adj"] = torch.where(cp < threshold, torch.zeros_like(cp), cp)
    return params


def gen_adj(a: torch.Tensor) -> torch.Tensor:
    """Symmetric degree normalisation (A·D^-½)ᵀ·D^-½. Not applied by
    :func:`gcn_forward`, as in the reference: pass ``adj=gen_adj(A)`` for
    ML-GCN-style propagation."""
    d = a.sum(1).pow(-0.5)
    ad = a * d[None, :]
    return ad.t() * d[None, :]


def gcn_forward(params: dict, x: torch.Tensor, adj: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., C, D] → [..., C, D]: per layer adj @ (x @ W) (+ bias), with
    LeakyReLU(0.15) between the two layers. ``adj`` (else the shared
    ``params["adj"]``, else each layer's own ``A``)."""
    shared = params.get("adj") if adj is None else adj
    out = x
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        a = shared if shared is not None else layer["A"]
        out = a @ (out @ layer["weight"])
        if "bias" in layer:
            out = out + layer["bias"]
        if i + 1 < n:
            out = F.leaky_relu(out, 0.15)
    return out
