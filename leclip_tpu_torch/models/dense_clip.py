"""DenseCLIP forwards (counterpart of leclip_tpu/models/dense_clip.py): prompt
text features, the shared local-logits aggregation, exact top-k caption
retrieval, image features and test logits; and the training half: the frozen
caption features (texts as images, computed under ``torch.no_grad()``, the
counterpart of ``stop_gradient``) and the training logits of the prompt
branch, through which the gradients flow.

Where the JAX package vmaps over ensemble members, the port carries a
leading member axis instead: ``test_logits_from_features`` accepts text
features [..., C, E] and trainable scalars [...], and returns logits with
those leading axes in front."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..ops.attention import _mm32
from .clip import CLIPConfig, clip_encode_image
from .prompt import assemble_prompts
from .resnet import project_dense
from .text import encode_text_embeds, encode_text_sequence

NEG_MASK_VALUE = -10000.0
FIXED_LOGIT_SCALE = 4.0


class DenseFlags(NamedTuple):
    """Static method flags."""

    use_evidence: bool = False
    learn_scale: bool = False
    learn_spatial_scale: bool = False
    spatial_scale_text: float = 50.0
    spatial_scale_image: float = 50.0
    neg_prompt_wcls: bool = True
    attention_impl: str = "auto"  # ops/attention.py: "auto" | "xla" | "resident" | "pallas"


def _normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=eps)


def prompt_text_features(clip_params: dict, clip_cfg: CLIPConfig, trainable: dict,
                         constants: dict, flags: DenseFlags,
                         include_evidence: Optional[bool] = None,
                         adapter: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """Encode the three prompt sets → L2-normalised class embeddings
    (``adapter``: the adapter trainer's bottleneck, on this path only)."""
    prompts, prompts_neg, prompts_evd = assemble_prompts(
        trainable, constants, neg_prompt_wcls=flags.neg_prompt_wcls)
    heads = clip_cfg.transformer_heads
    eot = constants["eot_idx"]
    text = clip_params["text"]

    def enc(embeds):
        return _normalize(encode_text_embeds(text, embeds, eot, heads,
                                             impl=flags.attention_impl, adapter=adapter))

    out = {"pos": enc(prompts), "neg": enc(prompts_neg)}
    if include_evidence if include_evidence is not None else flags.use_evidence:
        out["evd"] = enc(prompts_evd)
    return out


def _scales(trainable: dict, flags: DenseFlags, train: bool):
    """(logit_scale, spatial scale): python floats, or tensors of the
    trainable scalars' shape (a member axis when members are stacked)."""
    logit_scale = (torch.exp(trainable["temperature"]) if flags.learn_scale
                   else FIXED_LOGIT_SCALE)
    fixed_spatial = flags.spatial_scale_text if train else flags.spatial_scale_image
    tmp_scale = (torch.exp(trainable["spatial_T"]) if flags.learn_spatial_scale
                 else fixed_spatial)
    return logit_scale, tmp_scale


def _bcast(scale, ndim: int):
    """Give a per-member scale tensor trailing singleton axes up to ``ndim``."""
    if isinstance(scale, torch.Tensor):
        return scale.reshape(scale.shape + (1,) * (ndim - scale.dim()))
    return scale


def _aggregate_local(spatial_feats: torch.Tensor, text_feats: Dict[str, torch.Tensor],
                     logit_scale, tmp_scale, use_evidence: bool,
                     pos_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared local-logits aggregation over spatial positions.

    spatial_feats [B, P, E]; text feats [..., C, E] → (logits_local
    [..., B, C], logits_neg [..., B, P, C]). Pads (``pos_mask`` −10000) get
    zero contribution explicitly; the Winner-Take-All product is computed on
    the raw logits (the stabilised form of the reference's masking)."""
    logits_raw = torch.einsum("bpe,...ce->...bpc", spatial_feats.float(),
                              text_feats["neg"].float())
    nd = logits_raw.dim()
    logit_scale = _bcast(logit_scale, nd)
    tmp_scale = _bcast(tmp_scale, nd)
    valid = None
    logits_neg = logits_raw
    if pos_mask is not None:
        valid = (pos_mask > NEG_MASK_VALUE / 2)[:, :, None]
        logits_neg = logits_raw + pos_mask[:, :, None]
    if use_evidence:
        logits_evd = torch.einsum("bpe,...ce->...bpc", spatial_feats.float(),
                                  text_feats["evd"].float())
        if pos_mask is not None:
            logits_evd = logits_evd + pos_mask[:, :, None]
        w = torch.softmax(
            tmp_scale * logits_raw * (logits_raw.amax(-1, keepdim=True) + 1.0), dim=-1)
        contrib = logits_raw * w
        prob_spatial = torch.softmax(logits_evd * tmp_scale, dim=-2)
        logits_neg = contrib if valid is None else torch.where(valid, contrib, 0.0)
    else:
        prob_spatial = torch.softmax(logits_neg * tmp_scale, dim=-2)
        if valid is not None:
            logits_neg = torch.where(valid, logits_raw, 0.0)
    logits_local = torch.sum(logit_scale * logits_neg * prob_spatial, dim=-2)
    return logits_local, logits_neg


class CaptionFeatures(NamedTuple):
    """Frozen text-tower encodings of a caption batch, shared between the
    student and EMA-teacher heads (the reference computes them once per step,
    Caption_distill_double.py:474-477)."""

    global_feat: torch.Tensor    # [B, E] L2-normalised EOT feature
    spatial_feats: torch.Tensor  # [B, L, E] L2-normalised per-token features
    pos_mask: torch.Tensor       # [B, L] additive pad mask (-10000 at pads)


def encode_captions(clip_params: dict, clip_cfg: CLIPConfig, captions: torch.Tensor,
                    flags: DenseFlags, q8: dict = None, fused: bool = False) -> CaptionFeatures:
    """Captions [B, 77] → frozen "image-like" features, without gradients.

    ``q8``: int8 text-tower weights (ops/quant.py), the W8A8 kernels;
    ``fused``: the bf16 block kernels (ops/block_kernels.py). Both kernels
    are forward-only, which is why this branch runs under ``no_grad``; the
    prompt branch keeps the plain math."""
    text = clip_params["text"]
    with torch.no_grad():
        embeds = text["token_embedding"][captions.long()]
        seq = encode_text_sequence(text, embeds, clip_cfg.transformer_heads,
                                   impl=flags.attention_impl, q8=q8, fused=fused)
    eot = captions.argmax(-1).long()
    global_feat = _normalize(seq[torch.arange(seq.shape[0], device=seq.device), eot])
    spatial_feats = _normalize(seq)
    pos_mask = (captions == 0).float() * NEG_MASK_VALUE
    return CaptionFeatures(global_feat, spatial_feats, pos_mask)


def _scaled_product(logit_scale, feat: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
    """``logit_scale * feat @ text.T`` with JAX's dtype promotion."""
    dt = torch.promote_types(feat.dtype, text.dtype)
    if isinstance(logit_scale, torch.Tensor):
        dt = torch.promote_types(dt, logit_scale.dtype)
    return (logit_scale * feat.to(dt)) @ text.to(dt).T


def train_logits_from_features(clip_params: dict, clip_cfg: CLIPConfig, trainable: dict,
                               constants: dict, feats_in: CaptionFeatures, flags: DenseFlags,
                               adapter: Optional[dict] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(prompt params, frozen caption features) → (logits_global, logits_local)."""
    feats = prompt_text_features(clip_params, clip_cfg, trainable, constants, flags,
                                 adapter=adapter)
    logit_scale, tmp_scale = _scales(trainable, flags, train=True)
    logits_global = _scaled_product(logit_scale, feats_in.global_feat, feats["pos"])
    logits_local, _ = _aggregate_local(feats_in.spatial_feats, feats, logit_scale, tmp_scale,
                                       flags.use_evidence, feats_in.pos_mask)
    return logits_global, logits_local


def dense_train_forward(clip_params: dict, clip_cfg: CLIPConfig, trainable: dict,
                        constants: dict, captions: torch.Tensor, flags: DenseFlags
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Texts-as-images training forward → (logits_global, logits_local)."""
    caption_feats = encode_captions(clip_params, clip_cfg, captions, flags)
    return train_logits_from_features(clip_params, clip_cfg, trainable, constants,
                                      caption_feats, flags)


def custom_clip_train_forward(clip_params: dict, clip_cfg: CLIPConfig, trainable: dict,
                              constants: dict, captions: torch.Tensor, flags: DenseFlags):
    """Global-only variant (ref CustomCLIP :338-352): caption EOT feature vs
    positive prompt features."""
    text = clip_params["text"]
    with torch.no_grad():
        embeds = text["token_embedding"][captions.long()]
        feat = encode_text_embeds(text, embeds, captions.argmax(-1), clip_cfg.transformer_heads,
                                  impl=flags.attention_impl)
    feat = _normalize(feat)
    feats = prompt_text_features(clip_params, clip_cfg, trainable, constants, flags,
                                 include_evidence=False)
    return _scaled_product(FIXED_LOGIT_SCALE, feat, feats["pos"]), None


def retrieval_augment(global_feat: torch.Tensor, caption_bank: torch.Tensor,
                      topk: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k caption retrieval: the mean of the k nearest bank features
    is averaged 50/50 into the image feature. Returns (augmented [B, E],
    topk scores [B, k] fp32). (The JAX package's approximate search above
    4096 rows is a TPU workaround and is not ported.)"""
    k_eff = min(topk, caption_bank.shape[0])
    sims = _mm32(global_feat, caption_bank.T)
    scores, idx = torch.topk(sims, k_eff, dim=-1)
    selected = caption_bank[idx]  # [B, k, E]
    merged = (global_feat + selected.mean(dim=1).to(global_feat.dtype)) / 2.0
    if k_eff < topk:  # tiny banks keep the advertised [B, topk] shape
        scores = torch.nn.functional.pad(scores, (0, topk - k_eff))
    return merged, scores


class ImageFeatures(NamedTuple):
    global_feat: torch.Tensor    # [B, E] L2-normalised
    spatial_feats: torch.Tensor  # [B, P, E] L2-normalised dense features


def encode_image_features(clip_params: dict, clip_cfg: CLIPConfig, images: torch.Tensor,
                          flags: DenseFlags, q8: dict = None,
                          fused: bool = False) -> ImageFeatures:
    """Frozen image tower → normalised global + dense features. ViT: the
    projected patch tokens; ``q8``: int8 image-tower weights (ops/quant.py);
    ``flags.attention_impl`` routes the unfused attention. ResNet: the trunk
    map through the pool's v/c projections (``project_dense``), beside the
    single-query pool's global feature, without the positional embedding."""
    out = clip_encode_image(clip_params, clip_cfg, images, dense=True, if_pos=False,
                            impl=flags.attention_impl, q8=q8, fused=fused, pool_map=False)
    if clip_cfg.is_vit:
        global_raw, tokens = out
        dense = tokens.reshape(tokens.shape[0], -1, tokens.shape[-1])
    else:
        global_raw, _, feat_map = out
        dense = project_dense(feat_map, clip_params["visual"]["attnpool"])
    return ImageFeatures(_normalize(global_raw), _normalize(dense))


class DenseTestOutput(NamedTuple):
    logits_global: torch.Tensor    # [..., B, C]
    logits_local: torch.Tensor     # [..., B, C]
    logits_neg: torch.Tensor       # [..., B, P, C]
    raw_sim: torch.Tensor          # [..., B, C]
    topk_sim_scores: torch.Tensor  # [B, k]


def test_logits_from_features(trainable: dict, text_feats: Dict[str, torch.Tensor],
                              image_feats: ImageFeatures, flags: DenseFlags,
                              caption_bank: Optional[torch.Tensor] = None, topk: int = 10,
                              precomputed_retrieval=None) -> DenseTestOutput:
    """(prompt text features, shared image features) → test logits.
    ``precomputed_retrieval=(augmented_global, topk_scores)`` lets the caller
    run the bank search once per batch for every member."""
    global_feat = image_feats.global_feat
    raw_sim = torch.einsum("be,...ce->...bc", global_feat.float(), text_feats["pos"].float())
    if precomputed_retrieval is not None:
        global_feat, topk_scores = precomputed_retrieval
    elif caption_bank is not None:
        global_feat, topk_scores = retrieval_augment(global_feat, caption_bank, topk)
    else:
        topk_scores = torch.zeros((global_feat.shape[0], topk), device=global_feat.device)

    logit_scale, tmp_scale = _scales(trainable, flags, train=False)
    pos = text_feats["pos"]
    dt = torch.promote_types(global_feat.dtype, pos.dtype)
    if isinstance(logit_scale, torch.Tensor):
        dt = torch.promote_types(dt, logit_scale.dtype)
    scaled = _bcast(logit_scale, pos.dim()) * global_feat.to(dt)  # [..., B, E]
    logits_global = scaled @ pos.to(dt).transpose(-1, -2)
    logits_local, logits_neg = _aggregate_local(
        image_feats.spatial_feats, text_feats, logit_scale, tmp_scale, flags.use_evidence)
    return DenseTestOutput(logits_global, logits_local, logits_neg, raw_sim, topk_scores)
