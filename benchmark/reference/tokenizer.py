"""CLIP's byte-level BPE tokenizer, a frozen copy of the plain math for the
benchmark's reference (SOT + BPE ids + EOT, 77-token zero-padded context,
EOT forced at the last slot on truncation). It reads the public vocabulary
file that ships in the checkout and imports nothing of the program."""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import unicodedata
from typing import Iterable, List, Sequence, Union

import numpy as np

# the public OpenAI BPE table, read as a raw file from the checkout
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_BPE_PATH = os.path.join(_ROOT, "leclip_tpu_torch", "assets", "bpe_simple_vocab_16e6.txt.gz")

CONTEXT_LENGTH = 77

_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _char_class(c: str) -> str:
    """'L' letter, 'N' number, 'S' whitespace, 'P' anything else."""
    cat = unicodedata.category(c)[0]
    if cat in ("L", "N"):
        return cat
    return "S" if c.isspace() else "P"


def _pretokenize(text: str) -> List[str]:
    """findall of CLIP's pre-tokenisation pattern over lower-cased text."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        lit = next((s for s in _SPECIALS + _CONTRACTIONS if text.startswith(s, i)), None)
        if lit is not None:
            out.append(lit)
            i += len(lit)
            continue
        cls = _char_class(text[i])
        if cls == "S":
            i += 1
            continue
        if cls == "N":
            out.append(text[i])
            i += 1
            continue
        j = i + 1
        while j < n and _char_class(text[j]) == cls:
            j += 1
        out.append(text[i:j])
        i = j
    return out


@functools.lru_cache()
def _byte_unicode_table() -> dict:
    """Reversible byte -> printable-unicode-char map (avoids BPE on raw bytes
    that include whitespace/control chars)."""
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    chars = keep[:]
    n = 0
    for b in range(256):
        if b not in keep:
            keep.append(b)
            chars.append(256 + n)
            n += 1
    return dict(zip(keep, (chr(c) for c in chars)))


def _clean_text(text: str) -> str:
    # NFC normalisation + double HTML-unescape, collapse whitespace.
    text = unicodedata.normalize("NFC", text)
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip()


def _pairs(word: Sequence[str]):
    return set(zip(word[:-1], word[1:]))


class ClipTokenizer:
    """Byte-pair-encoding tokenizer with the CLIP vocab (49408 entries)."""

    def __init__(self, bpe_path: str = DEFAULT_BPE_PATH):
        self.byte_encoder = _byte_unicode_table()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merge_lines = f.read().split("\n")
        # Same slice of the merge table the reference uses: entries
        # 1 .. 49152-256-2+1 (header line dropped).
        merge_lines = merge_lines[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in merge_lines]

        base = list(self.byte_encoder.values())
        vocab: List[str] = base + [c + "</w>" for c in base]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self._cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.sot_token = self.encoder["<|startoftext|>"]
        self.eot_token = self.encoder["<|endoftext|>"]
        self.vocab_size = len(vocab)

    def _bpe(self, token: str) -> str:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    merged.extend(word[i:])
                    break
                merged.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
            if len(word) == 1:
                break
            pairs = _pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _clean_text(text).lower()
        for token in _pretokenize(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def get_tokenizer(bpe_path: str = DEFAULT_BPE_PATH) -> ClipTokenizer:
    return ClipTokenizer(bpe_path)


def tokenize(
    texts: Union[str, Sequence[str]],
    context_length: int = CONTEXT_LENGTH,
    truncate: bool = True,
) -> np.ndarray:
    """Tokenize text(s) into a zero-padded [N, context_length] int32 array.

    SOT + BPE ids + EOT; on overflow either truncate (EOT forced at the last
    slot) or raise, matching the reference contract (clip/clip.py:185-221).
    """
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for n, text in enumerate(texts):
        ids = [tok.sot_token] + tok.encode(text) + [tok.eot_token]
        if len(ids) > context_length:
            if truncate:
                ids = ids[:context_length]
                ids[-1] = tok.eot_token
            else:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length {context_length}"
                )
        out[n, : len(ids)] = ids
    return out
