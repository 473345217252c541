"""Caption → multi-label extraction (the port's own copy of
leclip_tpu/data/labeling.py, on the port's own vocab).

Reproduces the behavior of the reference's nltk/WordNet pipeline (ref:
project/my_code/datasets/pazhou_distill_chatglm_multi_label_mix.py:102-143,
184-233) with a **deterministic, dependency-free** rule lemmatizer: captions
are lowercased and tokenized, each token is reduced to a lemma (irregular
table + plural suffix rules + a targeted verb-form rule that only fires when
the stripped stem is a known synonym word), and class synonyms are matched
longest-first (compound names before single words) with destructive
replacement so an already-consumed compound cannot re-trigger its parts.

Determinism matters: the reference's nltk/WordNet path varies across nltk
versions and needs downloaded corpora; this table-driven port is stable and
hermetic, and its outputs are cached to the same ``*_labels.pkl`` artifact
layout the reference uses.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Set

from .vocab import COCO_CLASSNAME_SYNONYMS, build_synonym_index

_WORD_RE = re.compile(r"[a-z0-9]+(?:'[a-z]+)?|[^\sa-z0-9]")

# Irregular noun plurals relevant to everyday caption vocabulary.
_IRREGULAR = {
    "men": "man",
    "women": "woman",
    "children": "child",
    "people": "people",
    "mice": "mouse",
    "geese": "goose",
    "feet": "foot",
    "teeth": "tooth",
    "knives": "knife",
    "wives": "wife",
    "lives": "life",
    "leaves": "leaf",
    "loaves": "loaf",
    "shelves": "shelf",
    "wolves": "wolf",
    "scarves": "scarf",
    "buses": "bus",
    "glasses": "glass",
    "skis": "ski",
    "scissors": "scissors",
    "sheep": "sheep",
    "series": "series",
    "species": "species",
    "this": "this",
    "his": "his",
    "is": "is",
    "its": "its",
    "has": "has",
    "was": "was",
    "gas": "gas",
    "as": "as",
    "us": "us",
    "does": "does",
    "goes": "goes",
    "shoes": "shoe",
    "dress": "dress",
    "grass": "grass",
    "cross": "cross",
    "address": "address",
    "business": "business",
    "pants": "pants",
    "jeans": "jeans",
    "shorts": "shorts",
}

_VOWELS = set("aeiou")


def _plural_to_singular(tok: str) -> str:
    irr = _IRREGULAR.get(tok)
    if irr is not None:
        return irr
    if len(tok) <= 3 or not tok.endswith("s"):
        return tok
    if tok.endswith("ss") or tok.endswith("us") or tok.endswith("is"):
        return tok
    if tok.endswith("ies") and len(tok) > 4:
        return tok[:-3] + "y"
    if tok.endswith(("ches", "shes", "xes", "zes", "sses", "oes")):
        return tok[:-2]
    if tok.endswith("ves") and len(tok) > 4:
        return tok[:-3] + "f"
    return tok[:-1]


class CaptionLabeler:
    """Extract an ``n_cls``-dim binary label vector from a caption."""

    def __init__(self, synonyms: List[List[str]] = COCO_CLASSNAME_SYNONYMS):
        self.synonyms = synonyms
        self.n_cls = len(synonyms)
        name2idx, compound, simple = build_synonym_index(synonyms)
        self.name2idx = name2idx
        # Fixed longest-first order (the reference iterates python sets, which
        # is process-dependent; sorting makes label extraction reproducible).
        self.compound = sorted(compound, key=lambda n: (-len(n), n))
        self.simple = sorted(simple, key=lambda n: (-len(n), n))
        # Vocabulary of synonym words, used to gate the verb-form rule so
        # "running" never becomes "run" but "skiing" maps to "ski" (the
        # reference's POS-guided verb lemmatization has the same effect).
        self._syn_words: Set[str] = set()
        for synset in synonyms:
            for name in synset:
                self._syn_words.update(name.split(" "))
                self._syn_words.add(name.replace(" ", ""))

    def _lemma(self, tok: str) -> str:
        base = _plural_to_singular(tok)
        if base in self._syn_words:
            return base
        # Verb-form rule: -ing / -ed with optional doubled consonant or
        # dropped 'e', only when the stem is a synonym word.
        for suffix in ("ing", "ed"):
            if tok.endswith(suffix) and len(tok) > len(suffix) + 2:
                stem = tok[: -len(suffix)]
                for cand in (stem, stem + "e", stem[:-1] if stem and stem[-1] == stem[-2:-1] else stem):
                    if cand in self._syn_words:
                        return cand
        return base

    def lemmatize(self, caption: str) -> str:
        toks = _WORD_RE.findall(caption.lower())
        return " ".join(self._lemma(t) for t in toks)

    def __call__(self, caption: str) -> List[int]:
        labels = [0] * self.n_cls
        for name in self.matched_names(caption):
            labels[self.name2idx[name]] = 1
        return labels

    def matched_names(self, caption: str) -> List[str]:
        """The synonym names that fired, in match order — the label format of
        the reference's filter artifact (ref filter_caption.py:33-76, whose
        get_class variant returns names rather than a binary vector).
        ``__call__`` derives the binary vector from this, so there is exactly
        ONE copy of the matching algorithm."""
        cap = " " + self.lemmatize(caption) + " "
        names: List[str] = []
        # Compounds first, destructively, so e.g. "hot dog" does not also
        # label "dog"; then single-word names.
        for name in self.compound:
            padded = " " + name + " "
            if padded in cap:
                names.append(name)
                cap = cap.replace(padded, " ")
        for name in self.simple:
            padded = " " + name + " "
            if padded in cap:
                names.append(name)
                cap = cap.replace(padded, " ")
        return names

    def label_many(self, captions: Sequence[str]) -> List[List[int]]:
        return [self(c) for c in captions]


def contains_chinese(text: str) -> bool:
    return any("一" <= ch <= "龥" for ch in text)
