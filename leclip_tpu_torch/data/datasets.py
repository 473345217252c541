"""Registered dataset builders (the port's own copy of
leclip_tpu/data/datasets.py) — the five caption-distillation dataset
variants of the reference (ref: project/my_code/datasets/
pazhou_distill_chatglm*.py), producing

    CaptionDataset(tokens [N,77] int32, labels [N,C] int8,
                   test_images: list of paths, classnames)

Variants:
* ``chatglm_caption_mix``   — the "best"-model recipe: single-label corpora,
  multi-label corpora (cached), templates (+ optional N² pairs), few-shot
  component prompts, full + sampled category-set combinations (mix.py:70-366)
* ``chatglm_caption_check`` — hard-class curricula (diff/diffh/difft):
  everything restricted/re-labeled to a hard-class list, optional challenge
  JSONL corpus (check.py)
* ``chatglm_caption_zema``  — mix minus few-shot & subset sampling; uses
  imnames_{A|B}.json (zema.py)
* ``chatglm_caption_zuan``  — mix minus the category-set block (zuan.py)
* ``chatglm_caption``       — minimal variant: one {class_idx: [texts]} JSON,
  every text labeled one-hot (pazhou_distill_chatglm.py)
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from os.path import join
from typing import List

import numpy as np

from ..engine.config import Config
from ..utils.registry import DATASET_REGISTRY
from . import corpora
from .labeling import CaptionLabeler
from .vocab import COCO_OBJECT_CATEGORIES


@dataclass
class CaptionDataset:
    tokens: np.ndarray            # [N, 77] int32 training caption tokens
    labels: np.ndarray            # [N, C] int8 multi-hot labels
    test_images: List[str]        # image paths (unlabeled test split)
    classnames: List[str]
    caption_root: str = ""

    @property
    def num_classes(self) -> int:
        return len(self.classnames)

    @property
    def val_images(self) -> List[str]:
        # val = every 100th test image (pipeline smoke split, mix.py:364)
        return self.test_images[0::100]

    def __len__(self) -> int:
        return len(self.tokens)


def _load_classnames(root: str) -> List[str]:
    path = join(root, "classes.txt")
    if os.path.exists(path):
        with open(path) as f:
            return [line.strip() for line in f if line.strip()]
    return list(COCO_OBJECT_CATEGORIES)


def _load_test_images(
    root: str, select: str, final: bool = True, img_dir: str = "images"
) -> List[str]:
    """mix/check read imnames_final{A}.json under images/ (mix.py:83-92);
    zema/zuan/plain read imnames_{A}.json under dataset_{A}/ (zema.py:85-92,
    zuan.py:83-92)."""
    name = f"imnames_final{select}.json" if final else f"imnames_{select}.json"
    path = join(root, name)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        imnames = json.load(f)
    return [join(root, img_dir, n.split("/")[-1]) for n in imnames]


def _caption_root(cfg: Config) -> str:
    return join(os.path.abspath(os.path.expanduser(cfg.DATASET.caption_feat_root)),
                "generated_captions")


def _data_root(cfg: Config) -> str:
    root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT)) if cfg.DATASET.ROOT else ""
    return join(root, f"official_{cfg.DATASET.dataset_select.lower()}") if root else ""


def _stack(parts) -> tuple:
    toks = np.concatenate([p[0] for p in parts if len(p[0])], axis=0)
    labs = np.concatenate([p[1] for p in parts if len(p[1])], axis=0)
    return toks, labs


def _text_part(samples):
    return corpora.tokenize_text_samples(samples)


@DATASET_REGISTRY.register(name="chatglm_caption_mix")
def build_mix(cfg: Config) -> CaptionDataset:
    croot = _caption_root(cfg)
    droot = _data_root(cfg)
    classnames = _load_classnames(droot)
    labeler = CaptionLabeler()
    parts = [_text_part(corpora.load_single_label_corpus(croot, labeler))]
    for name in str(cfg.TRAIN.Caption_name).split(" "):
        if name:
            parts.append(corpora.load_multi_label_corpus(croot, name, labeler))
    parts.append(_text_part(corpora.template_samples(classnames, add_n2=cfg.TRAIN.add_n2)))
    if cfg.TRAIN.add_few_shot:
        parts.append(_text_part(corpora.few_shot_component_samples(
            join(croot, "components_of_few_shot_classes.json"), classnames)))
    parts.append(_text_part(corpora.category_set_samples(
        join(croot, "category_sets.txt"), len(classnames), seed=cfg.SEED)))
    tokens, labels = _stack(parts)
    corpora.dump_class_freq(labels, croot, str(cfg.TRAIN.Caption_name))
    return CaptionDataset(tokens, labels, _load_test_images(droot, cfg.DATASET.dataset_select),
                          classnames, croot)


@DATASET_REGISTRY.register(name="chatglm_caption_check")
def build_check(cfg: Config) -> CaptionDataset:
    croot = _caption_root(cfg)
    droot = _data_root(cfg)
    classnames = _load_classnames(droot)
    labeler = CaptionLabeler()
    kind = cfg.TRAIN.hard_data or "hard"
    hard_idx = corpora.hard_class_indices(kind)
    hard_names = {"soft": corpora.SOFT_HARD_CLS, "hard": corpora.HARD_CLS,
                  "total": corpora.TOTAL_HARD_CLS}[kind]

    parts = [_text_part(corpora.load_single_label_corpus(croot, labeler,
                                                         restrict_to=hard_idx))]
    if cfg.TRAIN.challenge_data:
        parts.append(_text_part(corpora.load_challenge_corpus(
            join(croot, "challenge"), len(classnames))))
    # Main-corpus hard re-labeling, reproducing the reference's executed
    # behaviour (check.py:302-317): `torch.nonzero(gt == 1)[0].tolist()` takes
    # the FIRST positive index only, so a caption is kept iff its first
    # labeled class is hard, and its new label is that single class.
    for name in str(cfg.TRAIN.Caption_name).split(" "):
        if not name:
            continue
        toks, labs = corpora.load_multi_label_corpus(croot, name, labeler)
        first_pos = np.argmax(labs == 1, axis=1)
        keep = np.isin(first_pos, hard_idx)
        relabeled = np.zeros_like(labs[keep])
        relabeled[np.arange(keep.sum()), first_pos[keep]] = 1
        parts.append((toks[keep], relabeled))
    parts.append(_text_part(corpora.check_template_samples(classnames, hard_idx)))
    parts.append(_text_part(corpora.category_set_samples(
        join(croot, "category_sets.txt"), len(classnames),
        restrict_to_names=hard_names)))
    tokens, labels = _stack(parts)
    if not os.path.exists(join(croot, f"{cfg.TRAIN.Caption_name}_class_freq.pkl")):
        corpora.dump_class_freq(labels, croot, str(cfg.TRAIN.Caption_name))
    return CaptionDataset(tokens, labels, _load_test_images(droot, cfg.DATASET.dataset_select),
                          classnames, croot)


@DATASET_REGISTRY.register(name="chatglm_caption_zema")
def build_zema(cfg: Config) -> CaptionDataset:
    croot = _caption_root(cfg)
    droot = _data_root(cfg)
    classnames = _load_classnames(droot)
    labeler = CaptionLabeler()
    parts = [_text_part(corpora.load_single_label_corpus(croot, labeler))]
    for name in str(cfg.TRAIN.Caption_name).split(" "):
        if name:
            parts.append(corpora.load_multi_label_corpus(croot, name, labeler))
    # zema's N² pair block is unconditional — the `if i == 0` gate is
    # commented out in the reference (zema.py:278-285), so add_n2 is ignored.
    parts.append(_text_part(corpora.template_samples(classnames, add_n2=True)))
    parts.append(_text_part(corpora.category_set_samples(
        join(croot, "category_sets.txt"), len(classnames), include_samples=False)))
    tokens, labels = _stack(parts)
    corpora.dump_class_freq(labels, croot, str(cfg.TRAIN.Caption_name))
    return CaptionDataset(tokens, labels,
                          _load_test_images(droot, cfg.DATASET.dataset_select, final=False,
                                            img_dir=f"dataset_{cfg.DATASET.dataset_select}"),
                          classnames, croot)


@DATASET_REGISTRY.register(name="chatglm_caption_zuan")
def build_zuan(cfg: Config) -> CaptionDataset:
    croot = _caption_root(cfg)
    droot = _data_root(cfg)
    classnames = _load_classnames(droot)
    labeler = CaptionLabeler()
    parts = [_text_part(corpora.load_single_label_corpus(croot, labeler))]
    for name in str(cfg.TRAIN.Caption_name).split(" "):
        if name:
            parts.append(corpora.load_multi_label_corpus(croot, name, labeler))
    # zuan's N² pair block is unconditional, same as zema (zuan.py:277-284).
    parts.append(_text_part(corpora.template_samples(classnames, add_n2=True)))
    if cfg.TRAIN.add_few_shot:
        parts.append(_text_part(corpora.few_shot_component_samples(
            join(croot, "components_of_few_shot_classes.json"), classnames)))
    tokens, labels = _stack(parts)
    corpora.dump_class_freq(labels, croot, str(cfg.TRAIN.Caption_name))
    return CaptionDataset(tokens, labels,
                          _load_test_images(droot, cfg.DATASET.dataset_select, final=False,
                                            img_dir=f"dataset_{cfg.DATASET.dataset_select}"),
                          classnames, croot)


@DATASET_REGISTRY.register(name="chatglm_caption")
def build_plain(cfg: Config) -> CaptionDataset:
    """Minimal variant (ref pazhou_distill_chatglm.py): {Caption_name}.json is
    a {class_idx: [texts]} dict, every text labeled one-hot; the data root is
    hard-coded to A_datasets/ + dataset_A + imnames_A.json regardless of
    dataset_select (ref :22-33); TRAIN.IF_ablation empties the train split
    (ref :66). Deviation: the corpus directory comes from
    DATASET.caption_feat_root rather than the reference's os.getcwd()."""
    croot = _caption_root(cfg)
    root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT)) if cfg.DATASET.ROOT else ""
    droot = join(root, "A_datasets") if root else ""
    classnames = _load_classnames(droot)
    tokens, labels = corpora.load_class_indexed_corpus(
        join(croot, f"{cfg.TRAIN.Caption_name}.json"), len(classnames))
    if cfg.TRAIN.IF_ablation:
        tokens = tokens[:0]
        labels = labels[:0]
    return CaptionDataset(tokens, labels,
                          _load_test_images(droot, "A", final=False, img_dir="dataset_A"),
                          classnames, croot)


def build_dataset(cfg: Config) -> CaptionDataset:
    return DATASET_REGISTRY.get(cfg.DATASET.NAME)(cfg)
