"""OpenAI CLIP checkpoint names (counterpart of leclip_tpu/models/zoo.py): the
reference loader's model table, served from local files only.

``MODEL_URLS`` keeps the published URL of each checkpoint, whose path holds
its sha256. ``load(name_or_path)`` reads a local checkpoint file, or the
file a zoo name maps to in the cache directory (the URL's file name), after
checking its sha256. This module never downloads: a name whose file is not
in the cache raises and names the path it looked for."""

from __future__ import annotations

import hashlib
import os
from typing import Tuple

from .clip import CLIPConfig
from .convert import load_clip_weights

MODEL_URLS = {
    "RN50": "https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
    "RN101": "https://openaipublic.azureedge.net/clip/models/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
    "RN50x4": "https://openaipublic.azureedge.net/clip/models/7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd/RN50x4.pt",
    "RN50x16": "https://openaipublic.azureedge.net/clip/models/52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa/RN50x16.pt",
    "ViT-B/32": "https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "ViT-B/16": "https://openaipublic.azureedge.net/clip/models/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
    "ViT-L/14": "https://openaipublic.azureedge.net/clip/models/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
}

available_models = sorted(MODEL_URLS)


def expected_sha256(name: str) -> str:
    return MODEL_URLS[name].split("/")[-2]


def cached_path(name: str, root: str = "~/.cache/leclip") -> str:
    """Where the checkpoint of zoo name ``name`` is looked for."""
    return os.path.join(os.path.expanduser(root), os.path.basename(MODEL_URLS[name]))


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def resolve(name_or_path: str, cache_root: str = "~/.cache/leclip") -> str:
    """A local file as it is, else the sha256-checked cache file of a zoo
    name. Raises FileNotFoundError naming the path looked for."""
    if os.path.exists(name_or_path):
        return name_or_path
    if name_or_path not in MODEL_URLS:
        raise FileNotFoundError(
            f"{name_or_path!r} is neither a file nor one of {available_models}")
    target = cached_path(name_or_path, cache_root)
    if not os.path.exists(target):
        raise FileNotFoundError(
            f"{name_or_path}: no checkpoint at {target}; place the file published at "
            f"{MODEL_URLS[name_or_path]} there, or pass a local path (nothing is downloaded)")
    digest = _sha256(target)
    if digest != expected_sha256(name_or_path):
        raise RuntimeError(f"sha256 mismatch for {target}: {digest}")
    return target


def load(name_or_path: str, cache_root: str = "~/.cache/leclip",
         device="cpu") -> Tuple[CLIPConfig, dict]:
    """A CLIP checkpoint by local path or zoo name → (config, params)."""
    return load_clip_weights(resolve(name_or_path, cache_root), device=device)
