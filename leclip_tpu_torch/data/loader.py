"""Host-side data loading: the caption batcher of training, the (image,
caption) pair batcher of dual-encoder fine-tuning and threaded image decode
for evaluation (the port's own copy of ``CaptionBatcher``, ``PairBatcher``,
``load_image``, ``image_size`` and ``ImageBatcher`` in
leclip_tpu/data/loader.py), and the byte-level decoders of the scoring
service (``decode_bytes_batch`` and ``declared_pixels``, after
leclip_tpu/runtime/jpeg.py and cli/serve.py). ``ImageBatcher`` and
``decode_bytes_batch`` decode JPEGs with the native multithreaded libjpeg
runtime (runtime/jpeg.py, PIL's output bit for bit) when it is available, as
the JAX package's do, and everything else with PIL; runtime/jpeg.py counts
which decoder took each image. ``PairBatcher`` decodes the same way."""

from __future__ import annotations

import concurrent.futures
from typing import Iterator, List, Sequence, Tuple

import numpy as np


class CaptionBatcher:
    """Shuffled batches of (tokens, labels) with deterministic per-epoch
    permutations (set_epoch analogue): the JAX package's
    ``default_rng(seed + epoch)`` permutations, so both packages train on
    the same batches. Batches are padded up to the full batch size by
    wrapping around, so every step has the same shape.

    Under a data mesh each rank loads shard ``shard_index`` of
    ``num_shards``: the same contiguous slice of each epoch's permutation as
    the JAX package's (the reference's CustomDistributedSamplerWrapper,
    dassl/data/samplers.py:181-195), ``batch_size`` rows a rank a step (the
    DDP rule: the global batch is ``num_shards`` times it)."""

    def __init__(self, tokens: np.ndarray, labels: np.ndarray, batch_size: int, seed: int = 0,
                 shard_index: int = 0, num_shards: int = 1):
        assert len(tokens) == len(labels)
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} outside [0, {num_shards})")
        self.tokens = tokens
        self.labels = labels
        self.batch_size = batch_size
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards

    def steps_per_epoch(self) -> int:
        return max(1, len(self.tokens) // self.num_shards // self.batch_size)

    def epoch(self, epoch: int) -> Iterator[dict]:
        n = len(self.tokens)
        order = np.random.default_rng(self.seed + epoch).permutation(n)
        per_shard = n // self.num_shards
        order = order[self.shard_index * per_shard: (self.shard_index + 1) * per_shard]
        bs = self.batch_size
        for s in range(self.steps_per_epoch()):
            idx = order[s * bs : (s + 1) * bs]
            if len(idx) < bs:
                idx = np.concatenate([idx, order[: bs - len(idx)]])
            yield {
                "img": self.tokens[idx].astype(np.int32),
                "label": self.labels[idx].astype(np.float32),
            }


class PairBatcher:
    """(image, caption) pairs for dual-encoder fine-tuning: the host decodes
    the images and zero-pads each into ``bucket``; the augmentation runs on
    the device inside the train step (ops/preprocess.py
    ``preprocess_train_batch``).

    Yields {'image_u8': [B, bh, bw, 3] uint8, 'content': [B, 2] int32,
    'tokens': [B, 77] int32} numpy arrays: the JAX package's per-epoch
    permutation ``default_rng(seed + epoch)``, the same contiguous slice of
    it for shard ``shard_index`` of ``num_shards``, and modular indexing, so
    that the tail and a dataset smaller than a batch still give full
    batches. Images decode as ``ImageBatcher``'s do: the native decoder
    where it is available, else a PIL thread pool."""

    def __init__(self, image_paths: Sequence[str], captions: Sequence[str] = None,
                 tokens: np.ndarray = None, batch_size: int = 64, seed: int = 0,
                 workers: int = 8, bucket: Tuple[int, int] = (512, 512), shard_index: int = 0,
                 num_shards: int = 1):
        if (captions is None) == (tokens is None):
            raise ValueError("pass captions OR tokens")
        self.paths = list(image_paths)
        self.shard_index = shard_index
        self.num_shards = num_shards
        if tokens is None:
            from .tokenizer import tokenize

            tokens = tokenize(list(captions), truncate=True)
        if len(tokens) != len(self.paths):
            raise ValueError(f"{len(tokens)} captions for {len(self.paths)} images")
        self.tokens = np.asarray(tokens, np.int32)
        self.batch_size = batch_size
        self.seed = seed
        self.workers = workers
        self.bucket = bucket
        from ..runtime.jpeg import native_available

        self.native = native_available()

    def steps_per_epoch(self) -> int:
        return max(1, len(self.paths) // self.num_shards // self.batch_size)

    def _decode(self, paths: List[str]) -> List[np.ndarray]:
        if self.native:
            from ..runtime.jpeg import decode_batch

            return decode_batch(paths, threads=self.workers)
        with concurrent.futures.ThreadPoolExecutor(self.workers) as pool:
            return list(pool.map(load_image, paths))

    def epoch(self, epoch: int) -> Iterator[dict]:
        from ..inference.tta import pad_to_bucket

        n = len(self.paths)
        order = np.random.default_rng(self.seed + epoch).permutation(n)
        if self.num_shards > 1:
            per = n // self.num_shards
            order = order[self.shard_index * per: (self.shard_index + 1) * per]
        bs = self.batch_size
        for s in range(self.steps_per_epoch()):
            idx = order[np.arange(s * bs, (s + 1) * bs) % len(order)]
            padded, content = [], []
            for im in self._decode([self.paths[i] for i in idx]):
                p, hw = pad_to_bucket(im, self.bucket)
                padded.append(p)
                content.append(hw)
            yield {"image_u8": np.stack(padded), "content": np.asarray(content, np.int32),
                   "tokens": self.tokens[idx]}


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
