"""Caption corpus loaders and synthetic-sample factories (the port's own copy
of leclip_tpu/data/corpora.py, on the port's own tokenizer and vocab).

Implements the training-data contract of the reference dataset builders
(ref: project/my_code/datasets/pazhou_distill_chatglm_multi_label_mix.py:
145-362, ..._check.py:255-375, ..._zema.py): ChatGLM single-label JSONs with
rule filtering, multi-label caption JSONs with pickle caching of labels and
tokenizations (same ``{name}_labels.pkl`` / ``{name}_all_caption_tokenized.pkl``
artifact names), challenge JSONL corpora, "a photo of a {}" / ImageNet-template
synthesis, N² pair prompts, few-shot component prompts, and the 122k-line
category-set combinations with random-subset sampling.

Outputs are (tokens [77] int32, labels [80] int8) pairs — numpy throughout;
nothing here touches the device.
"""

from __future__ import annotations

import json
import os
import pickle
import random
from os.path import join
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .labeling import CaptionLabeler, contains_chinese
from .tokenizer import tokenize
from .vocab import (
    COCO_OBJECT_CATEGORIES,
    IMAGENET_TEMPLATES,
    PROMPT_TEMPLATE,
    build_synonym_index,
)

Sample = Tuple[np.ndarray, np.ndarray]

# Hard-class curricula for the diff/diffh/difft models (ref ..._check.py:44-52)
SOFT_HARD_CLS = [
    "bicycle", "truck", "bench", "suitcase", "frisbee", "snowboard", "bottle",
    "cup", "fork", "bowl", "apple", "sandwich", "orange", "carrot", "chair",
    "dining table", "mouse", "keyboard", "cell phone", "refrigerator", "book",
    "vase",
]
HARD_CLS = [
    "parking meter", "backpack", "handbag", "knife", "spoon", "potted plant",
    "remote", "microwave", "toaster", "scissors", "hair drier", "toothbrush",
]
TOTAL_HARD_CLS = HARD_CLS + SOFT_HARD_CLS
CHALLENGE_HARD_CLS = [
    "parking meter", "backpack", "handbag", "knife", "spoon", "remote",
    "toaster", "scissors", "hair drier",
]

_NAME2IDX, _, _ = build_synonym_index()


def hard_class_indices(kind: str) -> List[int]:
    table = {"soft": SOFT_HARD_CLS, "hard": HARD_CLS, "total": TOTAL_HARD_CLS}
    return [_NAME2IDX[c] for c in table[kind]]


def _rule_filter(line: str) -> bool:
    """Single-label caption filter: no Chinese, 5 < len < 150, digit-prefixed
    (numbered ChatGLM output)."""
    return (
        not contains_chinese(line)
        and len(line) > 5
        and line[0].isdigit()
        and len(line) < 150
    )


def _strip_number(line: str) -> str:
    return " ".join(line.split(". ")[1:])


def load_single_label_corpus(
    root: str,
    labeler: CaptionLabeler,
    files: Optional[Sequence[str]] = None,
    restrict_to: Optional[Sequence[int]] = None,
) -> List[Tuple[str, List[int]]]:
    """ChatGLM_single_label_*.json: {class_idx: [numbered lines]} → labeled
    captions (forced class idx). ``restrict_to`` keeps only hard classes
    (the _check curriculum)."""
    files = files or [f"ChatGLM_single_label_{i}.json" for i in range(1, 6)]
    out: List[Tuple[str, List[int]]] = []
    restrict = set(restrict_to) if restrict_to is not None else None
    for fname in files:
        path = join(root, fname)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            info = json.load(f)
        for cidx, lines in info.items():
            cidx = int(cidx)
            if restrict is not None and cidx not in restrict:
                continue
            for line in lines:
                if _rule_filter(line):
                    labels = labeler(line)
                    labels[cidx] = 1
                    out.append((_strip_number(line), labels))
    return out


def load_multi_label_corpus(
    root: str,
    name: str,
    labeler: CaptionLabeler,
    cache: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """{name}.json — list of {id, caption} — labeled via synonym matching and
    tokenized, with the reference's pickle cache artifacts.

    Returns (tokens [N, 77] int32, labels [N, C] int8) for captions that hit
    at least one class."""
    labels_pkl = join(root, f"{name}_labels.pkl")
    tokens_pkl = join(root, f"{name}_all_caption_tokenized.pkl")

    if cache and os.path.exists(labels_pkl) and os.path.exists(tokens_pkl):
        with open(labels_pkl, "rb") as f:
            word_based: Dict = pickle.load(f)
        with open(tokens_pkl, "rb") as f:
            tokens = np.asarray(pickle.load(f), np.int32)
        labels = np.asarray(list(word_based.values()), np.int8)
        return tokens, labels

    with open(join(root, f"{name}.json")) as f:
        caption_info = json.load(f)
    id2cap = {item["id"]: item["caption"] for item in caption_info}

    word_based = {}
    empty = set()
    for capid, cap in id2cap.items():
        L = labeler(cap)
        if any(L):
            word_based[capid] = L
        else:
            empty.add(capid)

    kept_ids = list(word_based.keys())
    tokens = tokenize([id2cap[i] for i in kept_ids], truncate=True)
    labels = np.asarray([word_based[i] for i in kept_ids], np.int8)

    if cache:
        with open(labels_pkl, "wb") as f:
            pickle.dump(word_based, f)
        with open(join(root, f"{name}_filterword_empty.pkl"), "wb") as f:
            pickle.dump(empty, f)
        with open(tokens_pkl, "wb") as f:
            pickle.dump(tokens, f)
    return tokens, labels


def load_class_indexed_corpus(path: str, n_cls: int = 80) -> Tuple[np.ndarray, np.ndarray]:
    """{Caption_name}.json as a {class_idx: [texts]} dict — the minimal
    ``pazhou_distill_chatglm`` variant's corpus contract: every text of class
    ``i`` is tokenized (truncate=True) and labeled one-hot ``i``, iterating
    classes 0..n_cls-1 (ref pazhou_distill_chatglm.py:43-60)."""
    with open(path) as f:
        texts_dict = json.load(f)
    texts: List[str] = []
    labels: List[List[int]] = []
    for cls_idx in range(n_cls):
        cls_texts = texts_dict[str(cls_idx)]
        label = [0] * n_cls
        label[cls_idx] = 1
        texts.extend(cls_texts)
        labels.extend([list(label)] * len(cls_texts))
    if not texts:
        return np.zeros((0, 77), np.int32), np.zeros((0, n_cls), np.int8)
    return tokenize(texts, truncate=True), np.asarray(labels, np.int8)


def load_challenge_corpus(
    challenge_root: str, n_cls: int = 80
) -> List[Tuple[str, List[int]]]:
    """challenge/*.jsonl — lines {labels: [classnames], captions: [numbered]}
    (ref ..._check.py:279-297)."""
    out = []
    if not os.path.isdir(challenge_root):
        return out
    for fname in sorted(os.listdir(challenge_root)):
        if not fname.endswith(".jsonl"):
            continue
        with open(join(challenge_root, fname)) as f:
            for raw in f:
                raw = raw.strip()
                if not raw:
                    continue
                line = json.loads(raw)
                multi = [0] * n_cls
                for cname in line["labels"]:
                    multi[_NAME2IDX[cname]] = 1
                for cap in line["captions"]:
                    if len(cap.split(". ")) > 1 and _rule_filter(cap):
                        out.append((_strip_number(cap), list(multi)))
    return out


def template_samples(
    classnames: Sequence[str] = COCO_OBJECT_CATEGORIES,
    default_prompt_num: int = 10,
    add_n2: bool = False,
    restrict_to: Optional[Sequence[int]] = None,
) -> List[Tuple[str, List[int], int]]:
    """Per-class prompt templates: "a photo of a {}" ×(default_prompt_num-1)
    + the 80 ImageNet templates; optional N² "a photo of a {A} and a {B}"
    pairs. Returns (text, labels, repeat) so the tokenisation of a repeated
    prompt happens once."""
    n_cls = len(classnames)
    restrict = set(restrict_to) if restrict_to is not None else None
    out = []
    for i in range(n_cls):
        if restrict is not None and i not in restrict:
            continue
        label = [0] * n_cls
        label[i] = 1
        out.append((PROMPT_TEMPLATE.format(classnames[i]), list(label), default_prompt_num - 1))
        for tmpl in IMAGENET_TEMPLATES:
            out.append((tmpl.format(classnames[i]), list(label), 1))
        if add_n2:
            for j in range(i + 1, n_cls):
                multi = [0] * n_cls
                multi[i] = 1
                multi[j] = 1
                text = PROMPT_TEMPLATE.format(f"{classnames[i]} and a {classnames[j]}")
                out.append((text, multi, default_prompt_num - 1))
    return out


def check_template_samples(
    classnames: Sequence[str] = COCO_OBJECT_CATEGORIES,
    hard_idx: Sequence[int] = (),
    default_prompt_num: int = 10,
) -> List[Tuple[str, List[int], int]]:
    """The _check curriculum's template block, reproducing the reference's
    executed behaviour exactly (ref ..._check.py:322-354): per HARD class i,
    "a photo of a {i}." ×(default_prompt_num-1) + the 80 ImageNet templates;
    PLUS an unconditional ``i == 0`` block — for every hard j, the pair prompt
    "a photo of a {classnames[0]} and a {j}." ×(default_prompt_num-1) and the
    80 ImageNet templates formatted with ``classnames[0]`` ONLY ("a bad photo
    of a person.") but still labeled {0, j}. That person-template labeling is
    the reference's literal behaviour (check.py:346-348), kept for parity."""
    n_cls = len(classnames)
    hard = set(hard_idx)
    out: List[Tuple[str, List[int], int]] = []
    for i in range(n_cls):
        if i in hard:
            label = [0] * n_cls
            label[i] = 1
            out.append((PROMPT_TEMPLATE.format(classnames[i]), list(label),
                        default_prompt_num - 1))
            for tmpl in IMAGENET_TEMPLATES:
                out.append((tmpl.format(classnames[i]), list(label), 1))
        if i == 0:
            for j in range(1, n_cls):
                if j not in hard:
                    continue
                multi = [0] * n_cls
                multi[0] = 1
                multi[j] = 1
                out.append((PROMPT_TEMPLATE.format(
                    f"{classnames[0]} and a {classnames[j]}"), list(multi),
                    default_prompt_num - 1))
                for tmpl in IMAGENET_TEMPLATES:
                    out.append((tmpl.format(classnames[0]), list(multi), 1))
    return out


def few_shot_component_samples(
    path: str, classnames: Sequence[str] = COCO_OBJECT_CATEGORIES
) -> List[Tuple[str, List[int]]]:
    """components_of_few_shot_classes.json: {classname: [component names]} →
    "{cls} and a {component}" prompts labeled with the class only."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        info = json.load(f)
    n_cls = len(classnames)
    out = []
    for key, comps in info.items():
        for cname in comps:
            label = [0] * n_cls
            label[_NAME2IDX[key]] = 1
            out.append((PROMPT_TEMPLATE.format(f"{key} and a {cname}"), label))
    return out


def category_set_samples(
    path: str,
    n_cls: int = 80,
    sample_m: int = 5,
    seed: int = 0,
    include_samples: bool = True,
    restrict_to_names: Optional[Sequence[str]] = None,
) -> List[Tuple[str, List[int]]]:
    """category_sets.txt: one comma-separated class combination per line.

    ① every full combination → "a photo of a A and a B and a …" with the full
    multi-label; ② (include_samples) for each unique ≥2-class combo, M random
    subsets (size 3..L) still labeled with the FULL combo (ref mix.py:306-354);
    ``restrict_to_names`` intersects combos with a hard-class list instead
    (the _check variant, labels = intersection only)."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        lines = f.readlines()

    out: List[Tuple[str, List[int]]] = []
    rng = random.Random(seed)
    restrict = set(restrict_to_names) if restrict_to_names is not None else None

    all_cates = set()
    for line in lines:
        cnames = line.strip("\n").split(",")
        if restrict is not None:
            ious = list(set(cnames) & restrict)
            if not ious:
                continue
            label = [0] * n_cls
            for c in ious:
                label[_NAME2IDX[c]] = 1
            out.append((PROMPT_TEMPLATE.format(" and a ".join(ious)), label))
            continue
        label = [0] * n_cls
        for c in cnames:
            label[_NAME2IDX[c]] = 1
        out.append((PROMPT_TEMPLATE.format(" and a ".join(cnames)), label))
        key = tuple(sorted(set(cnames)))
        if len(key) > 1:
            all_cates.add(key)

    if include_samples and restrict is None:
        for combo in sorted(all_cates):
            label = [0] * n_cls
            for c in combo:
                label[_NAME2IDX[c]] = 1
            if len(combo) < 4:
                subsets = [list(combo)]
            else:
                subsets = [
                    rng.sample(combo, rng.randint(3, len(combo)))
                    for _ in range(sample_m)
                ]
            for sub in subsets:
                out.append((PROMPT_TEMPLATE.format(" and a ".join(sub)), list(label)))
    return out


def dump_class_freq(
    train_labels: np.ndarray, root: str, caption_name: str, keep_gt: bool = False
) -> str:
    """{Caption_name}_class_freq.pkl with class_freq / neg_class_freq (and
    optionally the full gt matrix), the DBL-loss artifact (ref mix.py:356-362)."""
    class_freq = train_labels.sum(axis=0).astype(np.int64)
    neg = train_labels.shape[0] - class_freq
    info = {"class_freq": class_freq, "neg_class_freq": neg}
    if keep_gt:
        info["gt_labels"] = train_labels
    path = join(root, f"{caption_name}_class_freq.pkl")
    with open(path, "wb") as f:
        pickle.dump(info, f)
    return path


def load_class_freq(root: str, caption_name: str) -> Dict[str, np.ndarray]:
    with open(join(root, f"{caption_name}_class_freq.pkl"), "rb") as f:
        return pickle.load(f)


def tokenize_text_samples(
    samples: Iterable[Tuple],
) -> Tuple[np.ndarray, np.ndarray]:
    """(text, labels[, repeat]) tuples → stacked (tokens [N,77], labels [N,C]),
    tokenizing each unique text once and repeating rows as requested."""
    texts, labels, repeats = [], [], []
    for item in samples:
        if len(item) == 3:
            text, lab, rep = item
        else:
            text, lab = item
            rep = 1
        texts.append(text)
        labels.append(lab)
        repeats.append(rep)
    if not texts:
        return np.zeros((0, 77), np.int32), np.zeros((0, 80), np.int8)
    toks = tokenize(texts, truncate=True)
    toks = np.repeat(toks, repeats, axis=0)
    labs = np.repeat(np.asarray(labels, np.int8), repeats, axis=0)
    return toks, labs
