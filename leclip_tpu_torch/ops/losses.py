"""Loss library on tensors (counterpart of leclip_tpu/ops/losses.py): every
loss the reference ships, as pure functions of (logits, labels, …) that
autograd differentiates.

Semantics mirrors (ref file:line):
* ranking_loss / ranking_loss_with_cooccurrence / ranking_loss_reweighting —
  project/my_code/trainers/utils.py:85-124
* soft_cross_entropy / softmax_sigmoid_BCE / norm_logits_BCE /
  sigmoid_focal — utils.py:10-50
* asymmetric loss (ASL, partial + full) — utils.py:126-190
* KL distillation (batchmean, the EMA loss) — Caption_distill_double.py:792,810-811
* ResampleLoss (Distribution-Balanced Loss) — trainers/dbl.py:263-445
* SoftMarginHingeEmbedding (LMPT) — trainers/csel.py:6-29

``jnp.maximum(0, x)``'s gradient at x == 0 is ½ (JAX splits a tie between
its two arguments); ``torch.clamp`` gives 1 there. :func:`_relu` keeps
JAX's ½ so the two packages' gradients agree where a hinge sits exactly on
its margin."""

from __future__ import annotations

from typing import NamedTuple

import torch


class _Relu(torch.autograd.Function):
    """max(x, 0) with JAX's tie gradient: ½ at x == 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, min=0.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * ((x > 0).to(g.dtype) + 0.5 * (x == 0).to(g.dtype))


def _relu(x: torch.Tensor) -> torch.Tensor:
    return _Relu.apply(x)


# --------------------------- ranking family ---------------------------------


def ranking_loss(y_pred, y_true, scale=1.0, margin=1.0):
    """Pairwise margin hinge: for every (negative i, positive j) class pair,
    penalise margin - pred_j + pred_i. Sum over pairs, mean over batch."""
    y_pred = y_pred * scale
    y_true = y_true.float()
    tmp = margin - y_pred[:, None, :] + y_pred[:, :, None]  # [B, i, j]
    loss = _relu(tmp) * y_true[:, None, :] * (1.0 - y_true[:, :, None])
    return loss.sum(dim=(-2, -1)).mean()


def cooccurrence_weights(cooccurrence: torch.Tensor) -> torch.Tensor:
    """log(1/P) pair weights, diagonal zeroed, row-mean normalised
    (ref utils.py:99-103)."""
    w = torch.log(1.0 / (cooccurrence + 1e-6))
    w = w * (1.0 - torch.eye(w.shape[0], dtype=w.dtype, device=w.device))
    return w / w.mean(dim=-1, keepdim=True)


def ranking_loss_with_cooccurrence(y_pred, y_true, cooccurrence, scale=1.0, margin=1.0):
    y_pred = y_pred * scale
    y_true = y_true.float()
    tmp = margin - y_pred[:, None, :] + y_pred[:, :, None]
    partial = _relu(tmp) * cooccurrence_weights(cooccurrence)
    loss = partial * y_true[:, None, :] * (1.0 - y_true[:, :, None])
    return loss.sum(dim=(-2, -1)).mean()


def ranking_loss_reweighting(y_pred, y_true, class_weights, scale=1.0, margin=1.0):
    y_pred = y_pred * scale
    y_true = y_true.float()
    tmp = margin - y_pred[:, None, :] + y_pred[:, :, None]
    loss = (_relu(tmp) * y_true[:, None, :] * (1.0 - y_true[:, :, None])
            * class_weights[None, None, :])
    return loss.sum(dim=(-2, -1)).mean()


# --------------------------- CE / BCE family --------------------------------


def soft_cross_entropy(pred, soft_targets):
    logp = torch.log_softmax(pred, dim=-1)
    return (-soft_targets * logp).sum(dim=1).mean()


def _bce_with_logits(logits, targets):
    # numerically stable: max(x,0) - x*t + log(1+exp(-|x|))
    return _relu(logits) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))


def norm_logits_bce(pred, targets):
    return _bce_with_logits(pred, targets.to(pred.dtype)).mean()


def softmax_sigmoid_bce(pred, targets):
    prob = torch.clamp(torch.softmax(pred, dim=1), 1e-8, 1 - 1e-8)
    logit = torch.log(prob / (1 - prob))
    return _bce_with_logits(logit, targets.to(pred.dtype)).mean()


def sigmoid_focal_loss(inputs, targets, alpha=-1.0, gamma=2.0):
    """Soft-label focal: weight BCE by |t - p|^gamma (ref utils.py:25-50)."""
    p = torch.sigmoid(inputs)
    ce = _bce_with_logits(inputs, targets.to(inputs.dtype))
    loss = ce * torch.abs(targets - p) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss.mean()


def kl_distill_loss(student_logits, teacher_logits):
    """KLDivLoss(reduction='batchmean')(log_softmax(s), softmax(t)) — the EMA
    distillation term."""
    logp_s = torch.log_softmax(student_logits, dim=-1)
    p_t = torch.softmax(teacher_logits, dim=-1)
    logp_t = torch.log_softmax(teacher_logits, dim=-1)
    return (p_t * (logp_t - logp_s)).sum() / student_logits.shape[0]


# --------------------------- asymmetric loss --------------------------------


def asymmetric_loss(x, y, gamma_neg=2.0, gamma_pos=1.0, clip=0.05, eps=1e-8,
                    thresh_pos=0.9, thresh_neg=-0.9, partial=True):
    """ASL with asymmetric clipping + focusing; ``partial`` sums/B (dualcoop)
    vs mean (full-label)."""
    xs_pos = torch.sigmoid(x)
    xs_neg = 1.0 - xs_pos
    if clip and clip > 0:
        xs_neg = torch.clamp(xs_neg + clip, max=1.0)
    y_pos = (y > thresh_pos).to(x.dtype)
    y_neg = (y < thresh_neg).to(x.dtype)
    loss = (y_pos * torch.log(torch.clamp(xs_pos, min=eps))
            + y_neg * torch.log(torch.clamp(xs_neg, min=eps)))
    pt = (xs_pos * y_pos + xs_neg * y_neg).detach()
    one_sided_gamma = gamma_pos * y_pos + gamma_neg * y_neg
    loss = loss * ((1 - pt) ** one_sided_gamma).detach()
    if partial:
        return -loss.sum() / x.shape[0]
    return -loss.mean()


def dualcoop_loss(inputs, targets):
    return asymmetric_loss(inputs, targets, thresh_pos=0.9, thresh_neg=-0.9, partial=True)


def asl_loss(inputs, targets):
    return asymmetric_loss(inputs, targets, thresh_pos=0.9, thresh_neg=0.9, partial=False)


# --------------------------- Distribution-Balanced --------------------------


class ResampleLossParams(NamedTuple):
    """Static DBL parameters derived from the class-frequency statistics."""

    class_freq: torch.Tensor       # [C]
    train_num: float
    reweight_func: str = "rebalance"   # 'rebalance' | 'inv' | 'sqrt_inv' | ''
    focal: bool = False
    focal_gamma: float = 2.0
    focal_balance: float = 2.0
    map_alpha: float = 0.1
    map_beta: float = 10.0
    map_gamma: float = 0.2
    neg_scale: float = 1.0
    init_bias_factor: float = 0.0
    loss_weight: float = 1.0


def make_resample_loss_params(class_freq, neg_class_freq, device=None,
                              **kwargs) -> ResampleLossParams:
    class_freq = torch.as_tensor(class_freq, dtype=torch.float32, device=device)
    neg = torch.as_tensor(neg_class_freq, dtype=torch.float32)
    train_num = float(class_freq[0].item() + neg[0].item())
    return ResampleLossParams(class_freq=class_freq, train_num=train_num, **kwargs)


def resample_loss(logits, labels, p: ResampleLossParams):
    """Distribution-Balanced Loss (rebalanced weighted BCE with optional
    logit regularisation and focal term), matching dbl.py:263-445 with the
    trainer's config (rebalance, focal off, empty logit_reg)."""
    labels = labels.float()
    freq_inv = 1.0 / p.class_freq

    if p.reweight_func == "rebalance":
        repeat_rate = (labels * freq_inv).sum(dim=1, keepdim=True)
        pos_weight = freq_inv[None, :] / repeat_rate
        weight = torch.sigmoid(p.map_beta * (pos_weight - p.map_gamma)) + p.map_alpha
    elif p.reweight_func in ("inv", "sqrt_inv"):
        w = p.train_num / p.class_freq
        if p.reweight_func == "sqrt_inv":
            w = torch.sqrt(w)
        weight = w[None, :].expand(labels.shape)
    else:
        weight = torch.ones_like(labels)

    if p.init_bias_factor:
        init_bias = (-torch.log(p.train_num / p.class_freq - 1.0)
                     * p.init_bias_factor / p.neg_scale)
        logits = logits + init_bias
    if p.neg_scale != 1.0:
        logits = logits * (1 - labels) * p.neg_scale + logits * labels
        weight = weight / p.neg_scale * (1 - labels) + weight * labels

    bce = _bce_with_logits(logits, labels)
    if p.focal:
        pt = torch.exp(-bce)
        loss = p.focal_balance * ((1 - pt) ** p.focal_gamma) * weight * bce
    else:
        loss = weight * bce
    return p.loss_weight * loss.mean()


# --------------------------- LMPT hinge --------------------------------------


def soft_margin_hinge_loss(inputs, labels, class_counts, margin=0.2, gamma=2.0):
    """Class-frequency-scaled soft-margin hinge over per-(class, token)
    cosine distances (ref csel.py:6-29 + application
    Caption_distill_double.py:863-886). ``inputs``/``labels``: [B, C, L]."""
    dot = (inputs * labels).sum(dim=2)  # [B, C]
    cc = torch.as_tensor(class_counts, dtype=torch.float32, device=inputs.device)[None, :]
    m = margin / torch.sqrt(torch.sqrt(cc))
    hinge = _relu(m - dot)
    cw = (1.0 / cc) ** gamma
    cw = cw / cw.sum(dim=1, keepdim=True)
    return (hinge * cw).sum() / inputs.shape[0]


def lmpt_hinge_from_embeddings(caption_embeds, prompt_embeds, labels, class_counts,
                               m_ctx=2, margin=0.2, gamma=2.0):
    """Build the LMPT hinge inputs from raw embeddings: x = 1 - cos(caption
    token emb, prompt emb), y = ±1 from labels (ref :876-882)."""
    n = caption_embeds.shape[1] - m_ctx
    a = caption_embeds[:, :n, :][:, None]            # [B, 1, L, D]
    b = prompt_embeds[:, m_ctx:, :][None]            # [1, C, L, D]
    cos = (a * b).sum(-1) / (
        torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1) + 1e-8)
    x = 1.0 - cos                                     # [B, C, L]
    y = 2.0 * labels[:, :, None] - 1.0
    y = y.expand(x.shape)
    return soft_margin_hinge_loss(x, y, class_counts, margin=margin, gamma=gamma)
