"""AutoAugment on tensors (counterpart of leclip_tpu/ops/autoaugment.py): the
reference's four learned policies (Dassl dassl/data/transforms/
autoaugment.py: mlc for VOC/COCO multi-label, imagenet, cifar10, svhn), each
a list of sub-policies (p1, op1, mag1, p2, op2, mag2) applied with the op
library of ops/randaugment.py.

The policy tables (ops/_aa_policies.py) compile once into flat float32
arrays of op index, level, probability and sign flag per stage. The
magnitude index maps to the op's level as the reference's ranges tables do:
10 steps per op, a random sign for shear / translate / enhance ops,
posterize down to 4 bits, solarize thresholds 256 → 0. Geometric ops warp
about the image centre (the reference shears about the PIL origin; the
JAX package's documented deviation), fill 0.5. :func:`sample_autoaugment`
draws the sub-policy and each stage's uniforms; :func:`autoaugment_apply`
is deterministic in them."""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ._aa_policies import POLICIES
from .randaugment import (autocontrast, brightness, color, contrast, equalize, invert, posterize,
                          rotate, sharpness, shear_x, shear_y, solarize, translate_x, translate_y)

# policy op name → kernel; the order is frozen, compiled tables index it
AA_OPS = [
    ("shearx", shear_x), ("sheary", shear_y), ("translatex", translate_x),
    ("translatey", translate_y), ("rotate", rotate), ("color", color),
    ("posterize", posterize), ("solarize", solarize), ("contrast", contrast),
    ("sharpness", sharpness), ("brightness", brightness),
    ("autocontrast", autocontrast), ("equalize", equalize), ("invert", invert),
]
_OP_INDEX = {name: i for i, (name, _) in enumerate(AA_OPS)}
_SIGNED = {"shearx", "sheary", "translatex", "translatey", "color",
           "contrast", "sharpness", "brightness"}
_RANGES = {
    "shearx": np.linspace(0, 0.3, 10),
    "sheary": np.linspace(0, 0.3, 10),
    "translatex": np.linspace(0, 150 / 331, 10),
    "translatey": np.linspace(0, 150 / 331, 10),
    "rotate": np.linspace(0, 30, 10),
    "color": np.linspace(0.0, 0.9, 10),
    "posterize": np.round(np.linspace(8, 4, 10), 0).astype(np.int32),
    "solarize": np.linspace(256, 0, 10),
    "contrast": np.linspace(0.0, 0.9, 10),
    "sharpness": np.linspace(0.0, 0.9, 10),
    "brightness": np.linspace(0.0, 0.9, 10),
    "autocontrast": np.zeros(10),
    "equalize": np.zeros(10),
    "invert": np.zeros(10),
}


def _op_level(name: str, mag_idx: int) -> float:
    """A reference magnitude index → the op library's signed-level
    convention."""
    mag = float(_RANGES[name][mag_idx])
    if name in ("shearx", "sheary"):
        return mag                      # the shear coefficient
    if name in ("translatex", "translatey"):
        return 3.0 * mag                # the op shifts level·size/3
    if name == "rotate":
        return mag / 30.0               # the op rotates level·30°
    if name == "posterize":
        return (8.0 - mag + 0.5) / 6.0  # the op keeps 8 − floor(|level|·6) bits
    if name == "solarize":
        return 1.0 - mag / 256.0        # threshold 1 − |level|
    return mag                          # enhance ops: blend factor 1 + level


@functools.lru_cache(maxsize=None)
def compile_policy(policy: str) -> dict:
    """A sub-policy table → numpy arrays [n, 2] of op index, level (float32),
    probability (float32) and sign flag."""
    rows = POLICIES[policy]
    cols = {k: [] for k in ("op", "lvl", "p", "sg")}
    for p1, op1, m1, p2, op2, m2 in rows:
        for p, op, m in ((p1, op1, m1), (p2, op2, m2)):
            cols["op"].append(_OP_INDEX[op])
            cols["lvl"].append(_op_level(op, m))
            cols["p"].append(p)
            cols["sg"].append(op in _SIGNED)
    n = len(rows)
    return dict(n=n, op=np.asarray(cols["op"], np.int32).reshape(n, 2),
                lvl=np.asarray(cols["lvl"], np.float32).reshape(n, 2),
                p=np.asarray(cols["p"], np.float32).reshape(n, 2),
                sg=np.asarray(cols["sg"], bool).reshape(n, 2))


class AutoAugmentDraws(NamedTuple):
    index: int           # the sub-policy
    u_apply: torch.Tensor  # [2] uniforms: stage s runs where u_apply[s] < p
    u_sign: torch.Tensor   # [2] uniforms: a signed op's level flips where < 0.5
    args: torch.Tensor     # [2, 2] each stage's op draws


def sample_autoaugment(generator: torch.Generator, policy: str = "mlc") -> AutoAugmentDraws:
    dev = generator.device
    n = compile_policy(policy)["n"]
    index = int(torch.randint(0, n, (), generator=generator, device=dev))
    return AutoAugmentDraws(index, torch.rand(2, generator=generator, device=dev),
                            torch.rand(2, generator=generator, device=dev),
                            torch.rand(2, 2, generator=generator, device=dev))


def autoaugment_apply(img: torch.Tensor, draws: AutoAugmentDraws,
                      policy: str = "mlc") -> torch.Tensor:
    """The drawn sub-policy of ``policy`` (mlc, imagenet, cifar10, svhn) on an
    image [H, W, C] in [0, 1]: two ops, each applied with its probability."""
    tbl = compile_policy(policy)
    i = draws.index
    for s in range(2):
        lvl = torch.tensor(tbl["lvl"][i, s])
        if tbl["sg"][i, s] and bool(draws.u_sign[s] < 0.5):
            lvl = -lvl
        if bool(draws.u_apply[s] < float(tbl["p"][i, s])):
            img = AA_OPS[int(tbl["op"][i, s])][1](img, lvl, draws.args[s])
    return img


def autoaugment(generator: torch.Generator, img: torch.Tensor,
                policy: str = "mlc") -> torch.Tensor:
    """One drawn sub-policy in one call: :func:`sample_autoaugment` from
    ``generator``, then :func:`autoaugment_apply` (the JAX package's
    ``autoaugment(key, img, policy)``, a generator in place of the key)."""
    return autoaugment_apply(img, sample_autoaugment(generator, policy), policy)
