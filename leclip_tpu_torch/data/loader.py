"""Host-side data loading: the caption batcher of training and threaded image
decode for evaluation (the port's own copy of ``CaptionBatcher``,
``load_image``, ``image_size`` and ``ImageBatcher`` in
leclip_tpu/data/loader.py), and the byte-level decoders of the scoring
service (``decode_bytes_batch`` and ``declared_pixels``, after
leclip_tpu/runtime/jpeg.py and cli/serve.py). ``ImageBatcher`` and
``decode_bytes_batch`` decode JPEGs with the native multithreaded libjpeg
runtime (runtime/jpeg.py, PIL's output bit for bit) when it is available, as
the JAX package's do, and everything else with PIL; runtime/jpeg.py counts
which decoder took each image."""

from __future__ import annotations

import concurrent.futures
from typing import Iterator, List, Sequence, Tuple

import numpy as np


class CaptionBatcher:
    """Shuffled batches of (tokens, labels) with deterministic per-epoch
    permutations (set_epoch analogue): the JAX package's
    ``default_rng(seed + epoch)`` permutations, so both packages train on
    the same batches. Batches are padded up to the full batch size by
    wrapping around, so every step has the same shape. One device: the JAX
    package's data shards wait for multi-GPU training."""

    def __init__(self, tokens: np.ndarray, labels: np.ndarray, batch_size: int, seed: int = 0):
        assert len(tokens) == len(labels)
        self.tokens = tokens
        self.labels = labels
        self.batch_size = batch_size
        self.seed = seed

    def steps_per_epoch(self) -> int:
        return max(1, len(self.tokens) // self.batch_size)

    def epoch(self, epoch: int) -> Iterator[dict]:
        order = np.random.default_rng(self.seed + epoch).permutation(len(self.tokens))
        bs = self.batch_size
        for s in range(self.steps_per_epoch()):
            idx = order[s * bs : (s + 1) * bs]
            if len(idx) < bs:
                idx = np.concatenate([idx, order[: bs - len(idx)]])
            yield {
                "img": self.tokens[idx].astype(np.int32),
                "label": self.labels[idx].astype(np.float32),
            }


def load_image(path: str) -> np.ndarray:
    """Decode one image with PIL to uint8 RGB [H, W, 3] (retry once on IO
    errors)."""
    from ..runtime.jpeg import pil_decode

    for attempt in range(2):
        try:
            return pil_decode(path)
        except OSError:
            if attempt:
                raise
    raise OSError(f"unreadable image {path}")


def decode_bytes_batch(blobs: Sequence[bytes], threads: int = 8) -> List[np.ndarray]:
    """Decode in-memory images (JPEG, PNG, ...; the serving path: no
    filesystem round trip) → list of uint8 RGB [H, W, 3] arrays: JPEGs by
    the native decoder when it is available, the rest by PIL."""
    from ..runtime.jpeg import decode_bytes_batch as decode

    return decode(blobs, threads)


def declared_pixels(blob: bytes) -> int:
    """Width x height from the image header alone, without decoding: a
    crafted JPEG declaring 60000x60000 would otherwise allocate ~10 GB."""
    import io

    from PIL import Image

    with Image.open(io.BytesIO(blob)) as im:
        w, h = im.size
    return w * h


def image_size(path: str) -> Tuple[int, int]:
    """(h, w) from the image header only."""
    from PIL import Image

    with Image.open(path) as im:
        w, h = im.size
    return h, w


class ImageBatcher:
    """Image decode → fixed-size batches of raw uint8 images plus their paths.
    JPEGs go through the native multithreaded decoder when it is available
    (``native=False`` keeps a PIL thread pool), everything else through PIL.

    ``sort_by_bucket`` orders the images by the shape bucket ``bucket_fn``
    maps them to (then by exact size), so one large image does not drag a
    batch to the largest bucket and uniform batches keep the shared-geometry
    crop path. ``inverse_order`` restores the input order."""

    def __init__(self, paths: Sequence[str], batch_size: int, workers: int = 8,
                 native: bool = True, sort_by_bucket: bool = False, bucket_fn=None):
        paths = list(paths)
        self.order = np.arange(len(paths))
        if sort_by_bucket and paths:
            if bucket_fn is None:
                from ..inference.tta import pick_bucket as bucket_fn
            with concurrent.futures.ThreadPoolExecutor(workers) as pool:
                sizes = list(pool.map(image_size, paths))
            keys = []
            for h, w in sizes:
                bh, bw = bucket_fn(h, w)
                keys.append((bh * bw, bh, bw, h, w))
            self.order = np.asarray(sorted(range(len(paths)), key=lambda i: keys[i]), np.int64)
            paths = [paths[i] for i in self.order]
        self.paths = paths
        self.batch_size = batch_size
        self.workers = workers
        self.native = False
        if native:
            from ..runtime.jpeg import native_available

            self.native = native_available()

    @property
    def inverse_order(self) -> np.ndarray:
        inv = np.empty_like(self.order)
        inv[self.order] = np.arange(len(self.order))
        return inv

    def __len__(self) -> int:
        return (len(self.paths) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[List[np.ndarray], List[str]]]:
        if self.native:
            from ..runtime.jpeg import decode_batch

            for start in range(0, len(self.paths), self.batch_size):
                chunk = self.paths[start: start + self.batch_size]
                yield decode_batch(chunk, threads=self.workers), chunk
            return
        with concurrent.futures.ThreadPoolExecutor(self.workers) as pool:
            for start in range(0, len(self.paths), self.batch_size):
                chunk = self.paths[start: start + self.batch_size]
                yield list(pool.map(load_image, chunk)), chunk
