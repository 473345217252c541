"""Full competition inference pipeline (counterpart of
leclip_tpu/inference/pipeline.py): the six prompt checkpoints grouped as the
reference's eval launcher groups them, scored over the multi-scale TTA
pyramid with image features shared by all members, fused with fuse/fuse6 +
per-class routing, and written as ``impreds.json``. With ``save_dir`` the
per-member dumps (``data.pkl``) and the shared retrieval sims
(``sim_matrix.pkl``) are written first and fused on the host, the
reference's dump-then-fuse flow; ``cli/gen_final_ans.py`` fuses such dumps
later.

Under a data mesh (one process per GPU, ``torchrun``) every rank feeds the
same image list and gets every score back; rank 0 alone writes
``impreds.json`` and the dumps."""

from __future__ import annotations

import os
import pickle
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.loader import ImageBatcher
from ..device import resolve_device, tree_map
from ..engine.checkpoint import load_prompt_params
from ..engine.config import resolve_test_precision
from ..engine.evaluator import MLClassificationEvaluator
from ..models.clip import CLIPConfig
from ..models.dense_clip import DenseFlags
from ..models.prompt import build_prompt_learner
from ..models.text import encode_text
from ..ops.ensemble import (DEFAULT_ROUTING, generate_final_answers, normalized_cooccurrence,
                            write_impreds)
from ..parallel.mesh import data_mesh
from ..parallel.multihost import is_primary
from .tta import ModelSpec, TTAEngine, build_model_spec

# the reference eval launcher's grouping: (names, use_evidence, use_freq, n_ctx)
DEFAULT_MODEL_GROUPS: Tuple[Tuple[Tuple[str, ...], bool, bool, Optional[int]], ...] = (
    (("best", "difft"), True, True, None),
    (("zema", "diff", "diffh"), False, False, None),
    (("ema",), False, False, 64),
)

def bank_fuses(device, batch_size: int) -> bool:
    """Whether the bf16 caption bank runs the fused block kernels: on a CUDA
    device, at a batch size the reference fuses (``batch_size % 8 == 0``)."""
    return torch.device(device).type == "cuda" and batch_size % 8 == 0


def build_caption_bank(clip_params: dict, clip_cfg: CLIPConfig, caption_tokens: np.ndarray,
                       batch_size: int = 256, dtype=np.float32, precision: str = "default",
                       device=None) -> np.ndarray:
    """Encode a caption corpus into the L2-normalised retrieval bank [N, E].

    ``precision='default'``: the text tower as given (fp32, plain math).
    ``precision='bf16'``: the tower cast to bf16; on CUDA at ``batch_size``
    % 8 == 0 it runs the fused bf16 block kernels (ops/block_kernels.py), as
    the JAX reference fuses only there (:func:`bank_fuses`).
    ``precision='int8'``: the causal text tower through the W8A8 kernels
    (ops/quant_kernels.py), its blocks quantized once here; the bank feeds
    top-k retrieval, which is insensitive to the quantization noise. On CUDA
    the tower is cast to bf16 first (the kernels take bf16 activations and
    parameters)."""
    device = resolve_device(device)
    text = tree_map(lambda t: t.to(device), clip_params["text"])
    to_bf16 = lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t  # noqa: E731
    q8 = None
    fused = False
    if precision == "int8":
        from ..ops.quant import quantize_stack_on_device

        if clip_cfg.transformer_width > 512:
            import warnings

            warnings.warn(
                f"int8 caption encoding at text width {clip_cfg.transformer_width}: the "
                "real-geometry task gate measured 768-wide causal text BREACHING the ±0.2 "
                "probe-mAP bound under physical outlier statistics (0.358/0.219, "
                "quant_gate_realwidth.json) — prefer precision='bf16' for >512-wide "
                "text towers"
            )
        if device.type == "cuda":
            text = tree_map(to_bf16, text)
        q8 = quantize_stack_on_device(text["blocks"])
    elif precision == "bf16":
        text = tree_map(to_bf16, text)
        fused = bank_fuses(device, batch_size)
    elif precision != "default":
        raise ValueError(f"unknown precision {precision!r}")

    n = len(caption_tokens)
    pad = (-n) % batch_size
    toks = np.concatenate([caption_tokens, caption_tokens[:pad]]) if pad else caption_tokens
    out = []
    with torch.inference_mode():
        for i in range(0, len(toks), batch_size):
            t = torch.as_tensor(np.asarray(toks[i: i + batch_size]), dtype=torch.long,
                                device=device)
            f = encode_text(text, t, clip_cfg.transformer_heads, q8=q8, fused=fused).float()
            out.append(f / torch.linalg.vector_norm(f, dim=-1, keepdim=True))
        bank = torch.cat(out)[:n].cpu().numpy()
    return bank.astype(dtype)


def load_ensemble_specs(cfg, clip_params: dict, clip_cfg: CLIPConfig,
                        classnames: Sequence[str], model_dir: str,
                        groups=DEFAULT_MODEL_GROUPS) -> Dict[str, ModelSpec]:
    """Load every member's prompt checkpoint and pre-encode its prompt text
    features (per-group n_ctx / evidence settings), on the device of
    ``clip_params``."""
    device = clip_params["text"]["token_embedding"].device
    specs: Dict[str, ModelSpec] = {}
    for names, use_evidence, use_freq, n_ctx in groups:
        flags = DenseFlags(
            use_evidence=use_evidence,
            learn_scale=cfg.TRAIN.IF_LEARN_SCALE,
            learn_spatial_scale=cfg.TRAIN.IF_LEARN_spatial_SCALE,
            spatial_scale_text=float(cfg.TRAIN.spatial_SCALE_text),
            spatial_scale_image=float(cfg.TRAIN.spatial_SCALE_image),
        )
        generator = torch.Generator(device=device).manual_seed(cfg.SEED)
        constants_cache: Dict[int, dict] = {}
        for name in names:
            try:
                trainable = load_prompt_params(model_dir, name, device=device)
            except FileNotFoundError:
                print(f"note: no checkpoint for ensemble member {name!r} — skipped")
                continue
            # the ctx shape in the checkpoint is authoritative (ema is 64)
            actual_nctx = int(trainable["ctx"].shape[-2])
            expect = n_ctx or cfg.TRAINER.N_CTX
            if actual_nctx != expect:
                print(f"note: {name} checkpoint has n_ctx={actual_nctx} "
                      f"(group default {expect}); using checkpoint value")
            if actual_nctx not in constants_cache:
                _, constants_cache[actual_nctx] = build_prompt_learner(
                    generator, clip_params, list(classnames), n_ctx=actual_nctx,
                    class_token_position=cfg.TRAINER.CLASS_TOKEN_POSITION,
                )
            specs[name] = build_model_spec(clip_params, clip_cfg, trainable,
                                           constants_cache[actual_nctx], flags,
                                           use_freq=use_freq)
    if not specs:
        raise FileNotFoundError(f"no ensemble checkpoints found under {model_dir!r}")
    return specs


def make_engine(cfg, clip_params, clip_cfg, specs, caption_bank=None, freq_stats=None,
                device=None, mesh="auto", shard_bank: bool = False) -> TTAEngine:
    """Config-driven TTAEngine construction: co-occurrence (TEST.use_freq is
    the master switch; per-member routing lives in ModelSpec.use_freq), the
    resolved precision (engine/config.py resolve_test_precision) and the
    data mesh. ``mesh="auto"``: the initialized process group's world where
    it holds more than one rank (one process per card, as the reference's
    DDP; the JAX package's "auto" takes every device of its one process),
    else none; a ``DataMesh`` or ``None`` overrides. ``shard_bank``
    row-shards the caption bank over the mesh."""
    cooc = None
    if freq_stats is not None and cfg.TEST.use_freq:
        cooc = normalized_cooccurrence(np.asarray(freq_stats["adj"], np.float32),
                                       np.asarray(freq_stats["nums"], np.float32))
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be 'auto', a DataMesh or None, got {mesh!r}")
        mesh = data_mesh(device) if (torch.distributed.is_initialized()
                                     and torch.distributed.get_world_size() > 1) else None
    device = mesh.device if mesh is not None else resolve_device(device)
    prec = resolve_test_precision(cfg.TEST.PREC, clip_cfg, device)
    if prec != cfg.TEST.PREC:
        print(f"TEST.PREC {cfg.TEST.PREC!r} resolved to {prec!r} for "
              f"{'ViT' if clip_cfg.is_vit else 'ResNet'} backbone on {device.type}")
    return TTAEngine(
        clip_params, clip_cfg, specs, scales=cfg.TEST.multi_scale,
        caption_bank=None if caption_bank is None else torch.as_tensor(caption_bank),
        cooccurrence=cooc, use_freq=False,
        topk=cfg.TEST.retrieval_topk,
        block_threshold=cfg.TEST.block_threshold,
        block_coef=cfg.TEST.block_fuse_coef,
        crop_size=clip_cfg.image_resolution,
        compute_dtype=torch.float32 if prec == "fp32" else torch.bfloat16,
        precision="int8" if prec == "int8" else "bf16",
        device=device, mesh=mesh, shard_bank=shard_bank,
    )


def run_full_inference(engine: TTAEngine, image_paths: Sequence[str], batch_size: int = 8,
                       save_dir: Optional[str] = None, out_json: Optional[str] = None,
                       routing=DEFAULT_ROUTING, progress: bool = True) -> np.ndarray:
    """TTA-score every image with every member and emit ``impreds.json``.
    Returns fused scores in the original ``image_paths`` order. Batches are
    bucket-sorted.

    ``save_dir=None``: the fused path, a producer thread decoding and
    uploading ahead of compute. Any other value: the dump path, each batch
    dispatched one ahead of the host copy of the one before; the dumps are
    pickled to ``save_dir`` as ``data.pkl`` (per member: output, output_pos
    [N, C], output_blocks, output_pos_blocks [N, n - 1, C], output_final,
    output_pos_final [N, C]) and ``sim_matrix.pkl`` (sims_all [N, k],
    sims_blocks_all [N, n - 1, k]) unless it is ``""``, then fused with
    ``routing``. Under a mesh every rank passes the same ``image_paths``
    and returns the same scores; rank 0 alone writes files and progress
    lines (the JAX package writes from every process)."""
    batcher = ImageBatcher(image_paths, batch_size, sort_by_bucket=True)
    inv = batcher.inverse_order
    primary = is_primary()
    progress = progress and primary
    if not primary:
        out_json = None
    if save_dir is None:
        parts = []
        batches = (images for images, _ in batcher)
        for bi, part in enumerate(engine.run_batches_fused_staged(batches, depth=2,
                                                                  stage_ahead=2)):
            parts.append(part)
            if progress:
                print(f"TTA batch {bi + 1}/{len(batcher)} (fused, pipelined)")
        fused = np.concatenate(parts)[inv]
        if out_json:
            write_impreds(fused, out_json)
        return fused

    acc: Dict[str, Dict[str, List[np.ndarray]]] = {}
    sims_all, sims_blocks_all = [], []

    def consume(handle, bi, n_images):
        results = engine.finish_batch_dump(handle)
        sims = results.pop("_sims")
        sims_all.append(sims["sims_all"])
        sims_blocks_all.append(sims["sims_blocks_all"])
        for name, outs in results.items():
            slot = acc.setdefault(name, {k: [] for k in outs})
            for k, v in outs.items():
                slot[k].append(v)
        if progress:
            print(f"TTA batch {bi + 1}/{len(batcher)} ({n_images} images)")

    pending = deque()
    for bi, (images, _) in enumerate(batcher):
        pending.append((engine.dispatch_batch_dump(images), bi, len(images)))
        if len(pending) >= 2:
            consume(*pending.popleft())
    while pending:
        consume(*pending.popleft())

    data = {name: {k: np.concatenate(v)[inv] for k, v in outs.items()}
            for name, outs in acc.items()}
    sims_blocks = np.concatenate(sims_blocks_all)[inv]
    if save_dir and primary:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "sim_matrix.pkl"), "wb") as f:
            pickle.dump({"sims_all": np.concatenate(sims_all)[inv],
                         "sims_blocks_all": sims_blocks}, f)
        with open(os.path.join(save_dir, "data.pkl"), "wb") as f:
            pickle.dump(data, f)

    first = next(iter(data.values()))
    MLClassificationEvaluator().process(first["output_final"],
                                        np.zeros_like(first["output_final"]),
                                        first["output_pos_final"])
    return generate_final_answers(data, sims_blocks, routing=routing, out_path=out_json)
