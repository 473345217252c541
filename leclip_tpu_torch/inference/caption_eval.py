"""Labeled caption benchmark scoring (counterpart of
leclip_tpu/inference/caption_eval.py): the captions-as-images analogue of
the image TTA path, which closes the accuracy loop on the ensemble stage.

The competition test images are unlabeled, and under random towers images
carry no label signal; captions do: the frozen TEXT tower is shared between
the training captions and the learned prompts (ref trainers/
Caption_distill_double.py:473-545, "texts as images"), so trained prompts
separate held-out labeled captions. Here the token axis plays the spatial
axis: a "block" is a contiguous token window of the caption, scored with the
``_aggregate_local`` that the train and test branches share, and the
model-independent block retrieval sims come from the window-mean feature
against the caption bank, the role crop-block retrieval plays at test time
(ref :444-448). Outputs use the per-model dict layout the fusion and routing
stage consumes (``output``, ``output_blocks``, ``output_pos``,
``output_pos_blocks`` + ``sims_blocks``), so ``ops.ensemble.model_result`` /
``route_ensemble`` run unchanged on top.

The caption features are encoded once per batch and shared by every
member; a bf16 text tower on the card runs the bf16 block kernels
(``encode_captions(fused=True)``), as the trainer's caption branch does."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..device import no_tf32, resolve_device, tree_map
from ..models.dense_clip import (NEG_MASK_VALUE, CaptionFeatures, _aggregate_local, _normalize,
                                 _scaled_product, _scales, encode_captions, retrieval_augment)
from .tta import ModelSpec


def caption_windows(n_pos: int = 77, scales: Sequence[int] = (2, 3, 4)) -> np.ndarray:
    """Contiguous token windows per scale, the 1-D analogue of the test
    loop's multi-scale crop grid (TEST.multi_scale (2,3,4) → s windows at
    scale s). Returns [n_blocks, 2] start/end."""
    wins = []
    for s in scales:
        edges = np.round(np.linspace(0, n_pos, s + 1)).astype(np.int64)
        wins.extend((int(edges[i]), int(edges[i + 1])) for i in range(s))
    return np.asarray(wins, np.int64)


def window_masks(windows: np.ndarray, n_pos: int = 77) -> np.ndarray:
    """[n_blocks, P] additive masks: 0 inside the window, -10000 outside
    (composes with the caption pad mask by addition)."""
    pos = np.arange(n_pos)
    inside = (pos[None, :] >= windows[:, :1]) & (pos[None, :] < windows[:, 1:])
    return np.where(inside, 0.0, NEG_MASK_VALUE).astype(np.float32)


def _window_mean_feats(feats: CaptionFeatures, wmasks: torch.Tensor) -> torch.Tensor:
    """L2-normalised mean token feature per window, the analogue of a crop
    block's global feature. [n_blocks, B, E]."""
    valid = (feats.pos_mask[None, :, :] + wmasks[:, None, :]) > NEG_MASK_VALUE / 2
    v = valid.to(feats.spatial_feats.dtype)                    # [W, B, P]
    summed = torch.einsum("wbp,bpe->wbe", v, feats.spatial_feats)
    count = torch.clamp(v.sum(dim=2, keepdim=True), min=1.0)  # [W, B, 1]
    return _normalize(summed / count)


def member_caption_scores(spec: ModelSpec, feats: CaptionFeatures,
                          wmasks: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Score one ensemble member on a caption batch → the per-model dict the
    fusion stage consumes, at the train branch's scales (the caption
    benchmark IS the texts-as-images branch; ref :473-545)."""
    tf = spec.text_feats
    logit_scale, tmp_scale = _scales(spec.trainable, spec.flags, train=True)
    out_global = _scaled_product(logit_scale, feats.global_feat, tf["pos"])
    out_local, _ = _aggregate_local(feats.spatial_feats, tf, logit_scale, tmp_scale,
                                    spec.flags.use_evidence, feats.pos_mask)
    wmeans = _window_mean_feats(feats, wmasks)  # [W, B, E]
    dt = torch.promote_types(wmeans.dtype, tf["pos"].dtype)
    g_blocks = logit_scale * torch.einsum("wbe,ce->wbc", wmeans.to(dt), tf["pos"].to(dt))
    l_blocks = torch.stack([
        _aggregate_local(feats.spatial_feats, tf, logit_scale, tmp_scale,
                         spec.flags.use_evidence, feats.pos_mask + wm[None, :])[0]
        for wm in wmasks])  # [W, B, C]
    return {"output": out_global, "output_pos": out_local,
            "output_blocks": g_blocks.transpose(0, 1),
            "output_pos_blocks": l_blocks.transpose(0, 1)}


def caption_sims_blocks(feats: CaptionFeatures, bank: torch.Tensor, wmasks: torch.Tensor,
                        topk: int = 10) -> torch.Tensor:
    """Model-independent per-block retrieval sims [B, n_blocks, k]:
    window-mean feature against the caption bank, once per batch for every
    member."""
    wmeans = _window_mean_feats(feats, wmasks)  # [W, B, E]
    w, b, e = wmeans.shape
    _, scores = retrieval_augment(wmeans.reshape(w * b, e), bank, topk)
    return scores.reshape(w, b, -1).transpose(0, 1)


def score_caption_benchmark(clip_params: dict, clip_cfg, specs: Dict[str, ModelSpec],
                            tokens: np.ndarray, bank=None, scales: Sequence[int] = (2, 3, 4),
                            batch_size: int = 256, topk: int = 10, device=None
                            ) -> Tuple[Dict[str, Dict[str, np.ndarray]], np.ndarray]:
    """Score every member over a tokenized caption set.

    Returns (per-model output dicts, sims_blocks) in numpy, ready for
    ``ops.ensemble.model_result`` / ``generate_final_answers``. The caption
    features and block retrieval are computed once per batch and shared by
    the members (the reference re-runs the encoder per member, :631).
    ``device`` defaults to the card (it raises without one); the text tower,
    the members and the bank are moved there."""
    device = resolve_device(device)
    text = tree_map(lambda t: t.to(device), clip_params["text"])
    clip_params = {"text": text}
    any_spec = next(iter(specs.values()))
    n_pos = int(tokens.shape[1])
    wmasks = torch.as_tensor(window_masks(caption_windows(n_pos, scales), n_pos), device=device)
    fused = device.type == "cuda" and text["blocks"]["ln_1"]["scale"].dtype == torch.bfloat16
    specs = {name: spec._replace(trainable=tree_map(lambda t: t.to(device), spec.trainable),
                                 text_feats=tree_map(lambda t: t.to(device), spec.text_feats))
             for name, spec in specs.items()}
    bank = None if bank is None else torch.as_tensor(bank).to(device)
    outs: Dict[str, Dict[str, list]] = {m: {} for m in specs}
    sims = []
    with torch.inference_mode(), no_tf32():
        for i in range(0, len(tokens), batch_size):
            chunk = torch.as_tensor(np.asarray(tokens[i:i + batch_size]), device=device)
            feats = encode_captions(clip_params, clip_cfg, chunk, any_spec.flags, fused=fused)
            for name, spec in specs.items():
                for key, v in member_caption_scores(spec, feats, wmasks).items():
                    outs[name].setdefault(key, []).append(v.float().cpu().numpy())
            if bank is not None:
                sims.append(caption_sims_blocks(feats, bank, wmasks, topk).float().cpu().numpy())
            else:
                sims.append(np.zeros((len(chunk), wmasks.shape[0], topk), np.float32))
    per_model = {m: {key: np.concatenate(v) for key, v in d.items()} for m, d in outs.items()}
    return per_model, np.concatenate(sims)
