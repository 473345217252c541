"""The plain reference of a caption-distillation training step (the ``ema``
recipe): the frozen text tower encodes a batch of captions as if they were
images (the EOT feature and every position's feature, normalised; pads
masked), the prompt learner's positive and negative prompts go through the
same tower with gradients to their context vectors, the EMA twin of the
prompt parameters moves first and scores the batch as the teacher, and the
loss is the two ranking hinges plus the teacher's KL terms (the local one
x10000); SGD with momentum and coupled weight decay takes the step.

Float32 with TF32 off, or the products' operands rounded as a control
(benchmark/reference/lowprec.py). Nothing here imports the program."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import clip_ref as C
from .score_ref import FIXED_LOGIT_SCALE, prompt_scaffold

NEG_MASK = -10000.0


def caption_features(text: dict, captions: torch.Tensor, heads: int, num: C.Numerics):
    """(normalised EOT features [B, E], normalised per-token features
    [B, L, E], additive pad mask [B, L])."""
    seq = C.text_sequence(text["token_embedding"].float()[captions.long()], text, heads, num)
    eot = captions.argmax(-1)
    g = C.normalize(seq[torch.arange(seq.shape[0], device=seq.device), eot])
    return g, C.normalize(seq), (captions == 0).float() * NEG_MASK


def prompt_features(text: dict, heads: int, scaffold, params: Dict[str, torch.Tensor],
                    num: C.Numerics) -> Dict[str, torch.Tensor]:
    sos, rest, eot = scaffold
    n = sos.shape[0]

    def enc(ctx):
        x = torch.cat([sos, ctx.float()[None].expand(n, -1, -1), rest], 1)
        return C.normalize(C.text_eot(x, eot, text, heads, num))

    return {"pos": enc(params["ctx"]), "neg": enc(params["ctx_double"])}


def head_logits(feats, cap, spatial_scale: float):
    """(global [B, C], local [B, C]) logits of one head."""
    g, spatial, mask = cap
    glob = FIXED_LOGIT_SCALE * g @ feats["pos"].T
    raw = spatial @ feats["neg"].T                                   # [B, L, C]
    prob = torch.softmax((raw + mask[:, :, None]) * spatial_scale, dim=1)
    neg = torch.where((mask > NEG_MASK / 2)[:, :, None], raw, torch.zeros_like(raw))
    return glob, (FIXED_LOGIT_SCALE * neg * prob).sum(1)


def ranking_loss(y: torch.Tensor, t: torch.Tensor, margin: float = 1.0) -> torch.Tensor:
    """Every (negative i, positive j) class pair's hinge margin - y_j + y_i,
    summed over the pairs, averaged over the rows."""
    tmp = margin - y[:, None, :] + y[:, :, None]
    return (torch.relu(tmp) * t[:, None, :] * (1.0 - t[:, :, None])).sum((-2, -1)).mean()


def kl_loss(student: torch.Tensor, teacher: torch.Tensor) -> torch.Tensor:
    """KL(softmax(teacher) || softmax(student)), summed, over the rows."""
    p = torch.softmax(teacher, -1)
    return (p * (torch.log_softmax(teacher, -1) - torch.log_softmax(student, -1))).sum() \
        / student.shape[0]


class Trainer:
    """The recipe's state and step, from ``params`` (the EMA twin equal to
    them and no momentum, as training starts) or from a state taken in
    mid-training (``ema``, ``trace``). ``rows``: a fault for the controls,
    the share of the batch the loss is taken over (1 = all of it)."""

    def __init__(self, text: dict, cfg: dict, recipe: dict, params: Dict[str, torch.Tensor],
                 num: C.Numerics = C.FP32, rows: float = 1.0,
                 ema: Dict[str, torch.Tensor] = None, trace: Dict[str, torch.Tensor] = None):
        self.text, self.cfg, self.recipe, self.num, self.rows = text, cfg, recipe, num, rows
        self.heads = cfg["transformer_heads"]
        n_ctx = params["ctx"].shape[-2]
        self.scaffold = prompt_scaffold(text["token_embedding"], cfg["classnames"], n_ctx)
        self.params = {k: v.detach().clone().float() for k, v in params.items()}
        self.ema = {k: (v if ema is None else ema[k]).detach().clone().float()
                    for k, v in self.params.items()}
        self.trace = {k: torch.zeros_like(v) if trace is None else trace[k].detach().clone().float()
                      for k, v in self.params.items()}
        self.grads: List[Dict[str, torch.Tensor]] = []
        self.losses: List[float] = []
        # each leaf's path length: the sum of its steps' norms
        self.path = {k: 0.0 for k in self.params}

    def step(self, captions: torch.Tensor, labels: torch.Tensor, lr: float) -> None:
        r, num = self.recipe, self.num
        keep = max(1, int(round(captions.shape[0] * self.rows)))
        captions, labels = captions[:keep], labels[:keep].float()
        with C.no_tf32():
            with torch.no_grad():
                cap = caption_features(self.text, captions, self.heads, num)
                m = r["ema_momentum"]
                self.ema = {k: m * self.ema[k] + (1.0 - m) * self.params[k] for k in self.ema}
                t_glob, t_loc = head_logits(
                    prompt_features(self.text, self.heads, self.scaffold, self.ema, num), cap,
                    r["spatial_scale_text"])
            leaves = {k: v.clone().requires_grad_(True) for k, v in self.params.items()}
            glob, loc = head_logits(
                prompt_features(self.text, self.heads, self.scaffold, leaves, num), cap,
                r["spatial_scale_text"])
            loss = (ranking_loss(glob, labels) + ranking_loss(loc, labels)
                    + kl_loss(glob, t_glob) + r["kl_local_weight"] * kl_loss(loc, t_loc))
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        raw = {k: torch.zeros_like(v) if g is None else g.detach()
               for (k, v), g in zip(leaves.items(), grads)}
        self.grads.append(raw)
        self.losses.append(float(loss.detach()))
        wd, mom = r["weight_decay"], r["sgd_momentum"]
        with torch.no_grad():
            for k in self.params:
                g = raw[k] + wd * self.params[k]
                self.trace[k] = g + mom * self.trace[k]
                self.params[k] = self.params[k] - lr * self.trace[k]
                self.path[k] += lr * float(self.trace[k].norm())


def norm_gaps(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keys: List[str], scale: Dict[str, float] = None) -> Tuple[float, Dict[str, float]]:
    """By the worst leaf: |‖got‖ - ‖ref‖| over the larger of the leaf's
    ``scale`` and the median leaf's (the lower median), ``scale`` the
    reference's norm of the leaf unless given."""
    scale = scale or {k: float(ref[k].float().norm()) for k in keys}
    med = float(torch.tensor([scale[k] for k in keys]).median())
    gaps = {k: abs(float(got[k].float().norm()) - float(ref[k].float().norm()))
            / max(scale[k], med, 1e-30) for k in keys}
    return max(gaps.values()), gaps
