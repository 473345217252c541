"""Multi-scale TTA inference engine (counterpart of leclip_tpu/inference/tta.py):
the fused path and the per-member dump path.

One pass per batch: uint8 images → 305 crops each (1 global + the 2/3/4
pyramid) → matmul bicubic resize → CLIP normalise → image tower once for all
members → one exact top-k retrieval against the caption bank → every
member's global/local logits (members of a group stacked on a leading axis)
→ fuse/fuse6 block fusion → per-class routing → fused [B, C] scores.

With a bf16 ViT on CUDA the image tower runs the hand-written bf16 block
kernels (``_fused``, the counterpart of the JAX engine's TPU switch). With
``precision="int8"`` the tower's blocks are quantized once at construction
(ops/quant.py) and every block runs the W8A8 kernels (ops/quant_kernels.py)
instead; the bf16 block kernels are then off for that engine. Unfused
towers (fp32 compute, ``bf16_fused=False``) route their attention by the
first member's ``DenseFlags.attention_impl``, as the JAX engine does: under
"auto" on CUDA the ViT's layers run the resident-attention kernel, and
"pallas" runs the flash-attention kernel in the image tower and (through
``build_model_spec``) in the prompt-feature text pass.

The dump path (``run_batch`` = ``dispatch_batch_dump`` + ``finish_batch_dump``)
shares the fused path's crops, image tower and retrieval, and returns every
member's raw global/local/block scores and block aggregates with the shared
retrieval sims, the dict that ``ops/ensemble.generate_final_answers`` fuses
(the reference's dump-then-fuse flow). ``run_batch_multidispatch`` is its
independently built check.

Under a data mesh (``mesh=``, a ``parallel.mesh.DataMesh``: one process per
GPU) every rank is given the same image list; the batch is padded with its
last image to a multiple of the world, each rank scores its own rows, and
the scores are gathered (``fetch_global``), so every rank returns the full
[B, C]. Parameters, members and the co-occurrence are broadcast from rank 0.
With ``shard_bank=True`` the caption bank is zero-padded to a multiple of
the world and row-sharded, and retrieval runs the ring kNN of
parallel/retrieval.py; otherwise every rank holds the whole bank.

With spans on (utils/tracing.py) a fused batch is ``score.stage`` (host prep
and upload), ``score.dispatch`` (the host queueing its work) holding the
device-timed ``score.resize``, ``score.image_tower``, ``score.retrieval``
and ``score.score_fuse``, and ``score.fetch`` (the wait for its scores).

Not ported yet (ROADMAP.md): the engine's ``resize_impl="gather"`` option
(the gather sampler itself is ops/crops.py ``crop_and_resize``)."""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import cast_floating, resolve_device, tree_map
from ..models.clip import CLIPConfig
from ..models.dense_clip import (
    DenseFlags,
    ImageFeatures,
    encode_image_features,
    prompt_text_features,
    retrieval_augment,
    test_logits_from_features,
)
from ..ops.crops import tta_sampling_boxes
from ..ops.ensemble import (DEFAULT_ROUTING, adjust_predictions, aggregate_blocks, fuse, fuse6,
                            routing_vector)
from ..ops.preprocess import clip_normalize
from ..ops.resize_matmul import crop_and_resize_matmul, crop_and_resize_matmul_batch
from ..parallel.mesh import DataMesh, fetch_global, gather_rows, put_global, replicate
from ..parallel.retrieval import retrieval_augment_sharded
from ..utils.tracing import span

DEFAULT_BUCKETS: Tuple[Tuple[int, int], ...] = (
    (256, 256), (384, 512), (512, 384), (512, 512), (512, 768), (768, 512),
    (768, 768), (768, 1024), (1024, 768), (1024, 1024), (1280, 1280),
)


def pick_bucket(h: int, w: int, buckets=DEFAULT_BUCKETS) -> Tuple[int, int]:
    for bh, bw in buckets:
        if h <= bh and w <= bw:
            return bh, bw
    return buckets[-1]


def pad_to_bucket(img: np.ndarray, bucket: Tuple[int, int]) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Zero-pad ``img`` into ``bucket``; returns (padded, content (h, w)).
    Oversized images are first downscaled (PIL bicubic, aspect kept), so the
    content dims are the post-resize dims."""
    bh, bw = bucket
    h, w = img.shape[:2]
    if h > bh or w > bw:
        from PIL import Image

        scale = min(bh / h, bw / w)
        nh, nw = max(1, int(h * scale)), max(1, int(w * scale))
        img = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BICUBIC), img.dtype)
        h, w = nh, nw
    out = np.zeros((bh, bw, 3), img.dtype)
    out[:h, :w] = img
    return out, (h, w)


class ModelSpec(NamedTuple):
    """One ensemble member: trainable prompt params, cached prompt text
    features, method flags, and its co-occurrence setting (None → inherit
    the engine's)."""

    trainable: dict
    text_feats: Dict[str, torch.Tensor]
    flags: DenseFlags
    use_freq: Optional[bool] = None


def build_model_spec(clip_params: dict, clip_cfg: CLIPConfig, trainable: dict,
                     constants: dict, flags: DenseFlags,
                     use_freq: Optional[bool] = None) -> ModelSpec:
    """Pre-encode the member's three prompt sets once."""
    with torch.inference_mode():
        feats = prompt_text_features(clip_params, clip_cfg, trainable, constants, flags)
    return ModelSpec(tree_map(lambda t: t.detach().clone(), trainable), feats, flags, use_freq)


class Staged(NamedTuple):
    n_boxes: int
    batch: int             # this rank's rows (all rows without a mesh)
    shared: bool
    images: torch.Tensor   # [B, bh, bw, 3] uint8 on the device
    boxes: torch.Tensor    # [n, 4] (shared) or [B, n, 4]
    content: np.ndarray    # [B, 2] content (h, w)
    n_real: int            # the caller's images before the mesh padding


class MeshRows(NamedTuple):
    """A dispatched batch under a mesh: this rank's rows on its device,
    gathered over the ranks and cut to the caller's ``n_real`` images by
    ``TTAEngine._fetch``."""

    rows: torch.Tensor
    mesh: DataMesh
    n_real: int


class TTAEngine:
    def __init__(
        self,
        clip_params: dict,
        clip_cfg: CLIPConfig,
        models: Dict[str, ModelSpec],
        scales: Tuple[int, ...] = (2, 3, 4),
        caption_bank: Optional[torch.Tensor] = None,
        cooccurrence: Optional[np.ndarray] = None,   # row-normalised P̂
        use_freq: bool = False,
        topk: int = 10,
        block_threshold: float = 0.3,
        block_coef: float = 1.4,
        compute_dtype=torch.float32,
        crop_size: int = 224,
        antialias: bool = True,
        precision: str = "bf16",
        bf16_fused: Optional[bool] = None,  # None = auto (bf16 ViT on CUDA)
        device=None,
        mesh: Optional[DataMesh] = None,    # batch split over the ranks
        shard_bank: bool = False,           # row-shard the bank: ring kNN retrieval
    ):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.shard_bank = bool(shard_bank)
        if self.shard_bank and (mesh is None or caption_bank is None):
            raise ValueError("shard_bank=True needs both a mesh and a caption_bank")
        if precision not in ("bf16", "int8"):
            raise ValueError(f"unknown precision {precision!r}")
        if precision == "int8" and not clip_cfg.is_vit:
            raise ValueError("precision='int8' currently supports ViT backbones only")
        self.precision = precision
        if bf16_fused is None:
            bf16_fused = (precision == "bf16" and clip_cfg.is_vit
                          and compute_dtype == torch.bfloat16 and self.device.type == "cuda")
        self._fused = bool(bf16_fused) and precision == "bf16" and clip_cfg.is_vit
        to_dev = self._replicated
        self.clip_params = to_dev(clip_params)
        if self._fused or (precision == "int8" and self.device.type == "cuda"):
            # the CUDA kernels take bf16 parameters: cast the image tower once
            self.clip_params = dict(self.clip_params)
            self.clip_params["visual"] = cast_floating(self.clip_params["visual"],
                                                       torch.bfloat16)
        self._q8 = None
        if precision == "int8":
            from ..ops.quant import quantize_stack_on_device

            self._q8 = quantize_stack_on_device(self.clip_params["visual"]["blocks"], mesh=mesh)
        self.clip_cfg = clip_cfg
        self.models = {
            name: spec._replace(trainable=tree_map(to_dev, spec.trainable),
                                text_feats=tree_map(to_dev, spec.text_feats))
            for name, spec in models.items()
        }
        self.scales = tuple(scales)
        self.caption_bank = None
        if caption_bank is not None:
            bank = torch.as_tensor(caption_bank)
            if self.shard_bank:
                # zero-pad (not wrap): the ring search excludes pad rows by
                # index (n_valid), so any bank retrieves as the replicated
                # path does; each rank keeps its contiguous rows
                self._bank_n_valid = bank.shape[0]
                pad = (-bank.shape[0]) % mesh.world
                bank = torch.cat([bank, bank.new_zeros((pad,) + tuple(bank.shape[1:]))])
                self._bank_rows = bank.shape[0]
                self.caption_bank = put_global(bank, mesh)
            else:
                self.caption_bank = to_dev(bank)
        self.cooccurrence = (None if cooccurrence is None else
                             to_dev(torch.as_tensor(np.asarray(cooccurrence, np.float32))))
        self.use_freq = use_freq and cooccurrence is not None
        self.topk = topk
        self.block_threshold = block_threshold
        self.block_coef = block_coef
        self.compute_dtype = compute_dtype
        self.crop_size = crop_size
        self.antialias = antialias
        _, counts = tta_sampling_boxes(480, 640, self.scales)
        self.n_blocks = sum(counts)
        self._groups = None
        self._routing = None

    def _replicated(self, tree):
        """``tree`` on the engine's device; under a mesh rank 0's value on
        every rank."""
        if self.mesh is not None:
            return replicate(tree, self.mesh)
        return tree_map(lambda t: t.to(self.device), tree)

    # ------------------------------ members ---------------------------------

    def _member_use_freq(self, spec: ModelSpec) -> bool:
        if self.cooccurrence is None:
            return False
        return self.use_freq if spec.use_freq is None else bool(spec.use_freq)

    def _model_groups(self):
        """Members grouped by (flags, ctx shapes, use_freq); each group's
        trainables and text features stacked on a leading member axis, so a
        group is scored in one batched pass."""
        if self._groups is not None:
            return self._groups
        by_key: Dict[tuple, List[str]] = {}
        for name, spec in self.models.items():
            shapes = tuple(sorted((k, tuple(v.shape)) for k, v in spec.trainable.items()))
            by_key.setdefault((spec.flags, shapes, self._member_use_freq(spec)), []).append(name)
        groups = []
        for (flags, _, use_freq), names in by_key.items():
            specs = [self.models[n] for n in names]
            tr = {k: torch.stack([s.trainable[k] for s in specs]) for k in specs[0].trainable}
            tf = {k: torch.stack([s.text_feats[k] for s in specs]) for k in specs[0].text_feats}
            groups.append((names, flags, use_freq, tr, tf))
        self._groups = groups
        names_order = [n for names, *_ in groups for n in names]
        base = "best" if "best" in names_order else names_order[0]
        n_cls = next(iter(self.models.values())).text_feats["pos"].shape[0]
        # names_order is the stacking order of dispatch_staged_fused: the
        # routing gather depends on the two sharing one ordering
        self._routing = (base, torch.as_tensor(
            routing_vector(names_order, DEFAULT_ROUTING, base=base, n_cls=n_cls),
            dtype=torch.long, device=self.device))
        return groups

    # --------------------------- mesh helpers -------------------------------

    def _mesh_pad(self, images: Sequence[np.ndarray]):
        """Pad the image list (by repeating the last image) so the batch
        divides the world; returns (padded list, original count)."""
        images = list(images)
        b = len(images)
        pad = 0 if self.mesh is None else (-b) % self.mesh.world
        return images + [images[-1]] * pad, b

    def _put_batch(self, x: np.ndarray) -> torch.Tensor:
        """A host array of the whole batch → this rank's rows on the device
        (every rank holds the same array, ``put_global``), all of it
        without a mesh."""
        if self.mesh is None:
            return torch.from_numpy(x).to(self.device)
        return put_global(x, self.mesh)

    def _host(self, out: torch.Tensor, dim: int = 0) -> np.ndarray:
        """Device rows → host fp32, every rank's rows along ``dim`` under a
        mesh."""
        if self.mesh is not None:
            return fetch_global(out.float(), self.mesh, dim)
        return out.float().cpu().numpy()

    # ------------------------------- passes ---------------------------------

    def prepare_batch(self, images: Sequence[np.ndarray]):
        """Host side: bucket-pad images and compute sampling boxes (global
        central square first, then the pyramid)."""
        buckets = [pick_bucket(*im.shape[:2]) for im in images]
        bucket = pick_bucket(max(b[0] for b in buckets), max(b[1] for b in buckets))
        padded, boxes, content = [], [], []
        for im in images:
            p, (h, w) = pad_to_bucket(im, bucket)
            pyramid, _ = tta_sampling_boxes(h, w, self.scales)
            side = min(h, w)
            gy, gx = (h - side) / 2.0, (w - side) / 2.0
            global_box = np.asarray([[gy, gx, gy + side, gx + side]], np.float32)
            boxes.append(np.concatenate([global_box, pyramid], axis=0))
            padded.append(p)
            content.append((h, w))
        return np.stack(padded), np.stack(boxes), np.asarray(content, np.int32), bucket

    def stage_batch_fused(self, images: Sequence[np.ndarray]) -> Staged:
        """Host prep + upload for one batch, without compute: lets a producer
        thread stage batches ahead of the compute loop. Under a mesh the
        host prepares the whole (padded) batch, as every rank does, and
        uploads this rank's rows."""
        with span("score.stage"):
            images, b0 = self._mesh_pad(images)
            padded, boxes, content, _ = self.prepare_batch(images)
            b, n = boxes.shape[0], boxes.shape[1]
            # every image with the same content size shares one crop geometry,
            # built once for the batch
            shared = bool((content == content[0]).all())
            im_d = self._put_batch(padded)
            bx_d = (torch.from_numpy(boxes[0]).to(self.device) if shared
                    else self._put_batch(boxes))
            if self.mesh is not None:
                per = b // self.mesh.world
                b, content = per, content[self.mesh.rank * per: (self.mesh.rank + 1) * per]
            return Staged(n, b, shared, im_d, bx_d, content, b0)

    def _crops(self, staged: Staged) -> torch.Tensor:
        imgs = staged.images.to(self.compute_dtype) / 255.0
        size = self.crop_size
        if staged.shared:
            h, w = (int(v) for v in staged.content[0])
            crops = crop_and_resize_matmul_batch(imgs, staged.boxes, size, self.antialias,
                                                 content_hw=(h, w))
        else:
            crops = torch.stack([
                crop_and_resize_matmul(imgs[i], staged.boxes[i], size, self.antialias,
                                       content_hw=tuple(int(v) for v in staged.content[i]))
                for i in range(staged.batch)
            ])
        return clip_normalize(crops)

    def _features(self, flat: torch.Tensor):
        """The image tower once for every member, under the first member's
        flags (its attention_impl), as the JAX engine does."""
        flags = next(iter(self.models.values())).flags
        return encode_image_features(self.clip_params, self.clip_cfg, flat, flags,
                                     q8=self._q8, fused=self._fused)

    def _retrieve(self, feats):
        """(augmented global features, top-k scores): one exact search of
        the caption bank for every member; with ``shard_bank`` the ring kNN
        over the row-sharded bank."""
        if self.shard_bank:
            return retrieval_augment_sharded(feats.global_feat, self.caption_bank, self.topk,
                                             self.mesh, n_valid=self._bank_n_valid,
                                             bank_rows=self._bank_rows)
        if self.caption_bank is not None:
            return retrieval_augment(feats.global_feat, self.caption_bank, self.topk)
        n = feats.global_feat.shape[0]
        return feats.global_feat, torch.zeros((n, self.topk), device=self.device)

    def _image_pass(self, staged: Staged):
        """crops → image tower → retrieval of a staged batch: (image
        features, augmented global features, top-k scores), shared by the
        fused and the dump path."""
        with span("score.resize", device=True):
            crops = self._crops(staged)
        with span("score.image_tower", device=True):
            feats = self._features(crops.reshape((-1,) + crops.shape[2:]))
        with span("score.retrieval", device=True):
            return (feats,) + tuple(self._retrieve(feats))

    def _group_logits(self, feats, aug, scores, b: int, n: int):
        """Per member group: (names, global and local logits [m, b, n, C] in
        fp32), the local ones co-occurrence-adjusted where the group uses
        frequencies. fp32 before any fusion, so fuse6's variances of bf16
        logits are not rounded to bf16 and both paths fuse the same values.
        Each image's n crops are scored by themselves, so that every fp32
        product has the same shape whatever the batch: cuBLAS picks its
        kernel (split-K among them) by shape, and a local-logits product of
        one image's rows summed in another order than in a batch of two or
        more, moving the image's scores by an fp32 ulp."""
        for names, flags, g_use_freq, tr, tf in self._model_groups():
            m = len(names)
            gs, locs = [], []
            for i in range(b):
                rows = slice(i * n, (i + 1) * n)
                one = ImageFeatures(feats.global_feat[rows], feats.spatial_feats[rows])
                out = test_logits_from_features(tr, tf, one, flags,
                                                precomputed_retrieval=(aug[rows], scores[rows]))
                loc = out.logits_local.reshape(m, 1, n, -1).float()
                if g_use_freq:
                    loc = adjust_predictions(loc, self.cooccurrence)
                gs.append(out.logits_global.reshape(m, 1, n, -1).float())
                locs.append(loc)
            yield names, torch.cat(gs, 1), torch.cat(locs, 1)

    def _score(self, feats, aug, scores, b: int, n: int) -> torch.Tensor:
        """Every member's global/local logits, fuse/fuse6 block fusion and
        the per-class routing → fused [B, C]. Fuses fp32 logits, as the dump
        path's host fusion does; JAX's ``_fused_fn`` fuses in the compute
        dtype (a departure of up to ~1e-3 on a bf16 engine). Reads
        ``self._routing``, which ``_model_groups`` has built."""
        base, routing = self._routing
        coef = 1.5
        sims_blocks = scores.reshape(b, n, -1)[:, 1:]
        results = []
        for names, g, loc in self._group_logits(feats, aug, scores, b, n):
            for mi, name in enumerate(names):
                use6 = name == base
                f = fuse6 if use6 else fuse
                aux_coef = 1.5 if use6 else 1.0
                o = g[mi, :, 0] + coef * f(g[mi, :, 1:], sims_blocks)
                a = loc[mi, :, 0] + coef * f(loc[mi, :, 1:], sims_blocks)
                results.append(o + aux_coef * a)
        stack = torch.stack(results)                              # [M, B, C]
        c = stack.shape[-1]
        return stack.permute(1, 2, 0).gather(2, routing[None, :, None].expand(b, c, 1))[..., 0]

    def dispatch_staged_fused(self, staged: Staged):
        """Score a staged batch → on-device fused [B, C] (not synchronised):
        crops → image tower → retrieval → members, fusion and routing. Under
        a mesh, a :class:`MeshRows` of this rank's rows, which
        :meth:`_fetch` gathers."""
        with span("score.dispatch"):
            self._model_groups()
            with torch.inference_mode():
                feats, aug, scores = self._image_pass(staged)
                with span("score.score_fuse", device=True):
                    out = self._score(feats, aug, scores, staged.batch, staged.n_boxes)
        if self.mesh is None:
            return out
        return MeshRows(out, self.mesh, staged.n_real)

    def dispatch_batch_fused(self, images: Sequence[np.ndarray]):
        return self.dispatch_staged_fused(self.stage_batch_fused(images))

    @staticmethod
    def _fetch(out) -> np.ndarray:
        """A dispatched batch → host fp32 [B, C]: under a mesh every rank's
        rows gathered and cut to the caller's images."""
        with span("score.fetch"):
            if isinstance(out, MeshRows):
                return fetch_global(out.rows.float(), out.mesh)[: out.n_real]
            return out.float().cpu().numpy()

    def run_batch_fused(self, images: Sequence[np.ndarray]) -> np.ndarray:
        """Competition scoring of one batch → fused [B, n_cls] (the
        impreds.json numbers)."""
        return self._fetch(self.dispatch_batch_fused(images))

    # ------------------------------ dump path -------------------------------

    def _dump_flat(self, feats, aug, scores, b: int, n: int) -> torch.Tensor:
        """Every group's fp32 logits (:meth:`_group_logits`), their block
        aggregates [m, b, C] and the retrieval sims [b, n, k], flattened into
        one fp32 buffer: one device→host copy a batch."""
        parts = []
        for names, g, loc in self._group_logits(feats, aug, scores, b, n):
            m = len(names)
            finals = [aggregate_blocks(x[:, :, 1:].reshape(m * b, n - 1, -1),
                                       self.block_threshold, self.block_coef,
                                       base=x[:, :, 0].reshape(m * b, -1))
                      for x in (g, loc)]
            parts += [g, loc] + finals
        parts.append(scores.reshape(b, n, -1).float())
        return torch.cat([p.reshape(-1) for p in parts])

    def dispatch_batch_dump(self, images: Sequence[np.ndarray]):
        """Queue the dump pass of one batch without synchronising: returns a
        handle for :meth:`finish_batch_dump`. On the card the flat buffer's
        copy to pinned host memory is queued right behind the batch's
        kernels, with an event after it: finishing batch i then waits for
        batch i's copy only, not for batch i+1, which the caller has queued
        since, so the host's next decode overlaps batch i+1's compute. Under
        a mesh every rank's flat buffer is gathered first."""
        staged = self.stage_batch_fused(images)
        self._model_groups()
        world = 1 if self.mesh is None else self.mesh.world
        with torch.inference_mode():
            feats, aug, scores = self._image_pass(staged)
            flat = self._dump_flat(feats, aug, scores, staged.batch, staged.n_boxes)
            if self.mesh is not None:
                flat = gather_rows(flat, self.mesh)
            done = None
            if flat.is_cuda:
                host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
                flat = host.copy_(flat, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
        return flat, done, staged.batch, staged.n_boxes, staged.n_real, world

    def finish_batch_dump(self, handle) -> Dict[str, dict]:
        """Wait for a :meth:`dispatch_batch_dump` handle's copy to the host
        (the one synchronisation) and unpack it into the per-member dump dict: output /
        output_pos [b, C], output_blocks / output_pos_blocks [b, n - 1, C],
        output_final / output_pos_final [b, C], and ``"_sims"`` with
        sims_all [b, k] and sims_blocks_all [b, n - 1, k]; numpy fp32.
        Under a mesh each rank's part is unpacked and the parts joined along
        the batch, cut to the caller's images."""
        flat, done, b, n, b0, world = handle
        if done is not None:
            done.synchronize()
        # a copy, so the pinned block goes back to the allocator's cache
        parts = [self._unpack_dump(chunk, b, n) for chunk in np.split(flat.numpy().copy(), world)]
        if world == 1:
            return parts[0]
        return {name: {k: np.concatenate([p[name][k] for p in parts])[:b0] for k in outs}
                for name, outs in parts[0].items()}

    def _unpack_dump(self, flat: np.ndarray, b: int, n: int) -> Dict[str, dict]:
        """One rank's flat dump buffer (:meth:`_dump_flat`) → the per-member
        dump dict of its ``b`` images."""
        n_cls = next(iter(self.models.values())).text_feats["pos"].shape[0]
        off = 0

        def take(shape):
            nonlocal off
            size = int(np.prod(shape))
            out = flat[off: off + size].reshape(shape)
            off += size
            return out

        per_model = {}
        for names, *_ in self._model_groups():
            m = len(names)
            g, loc = take((m, b, n, n_cls)), take((m, b, n, n_cls))
            g_final, l_final = take((m, b, n_cls)), take((m, b, n_cls))
            for mi, name in enumerate(names):
                per_model[name] = (g[mi], loc[mi], g_final[mi], l_final[mi])
        sims = take((b, n, self.topk))
        assert off == flat.size
        results: Dict[str, dict] = {}
        for name in self.models:
            g, loc, g_final, l_final = per_model[name]
            results[name] = {
                "output": g[:, 0],
                "output_pos": loc[:, 0],
                "output_blocks": g[:, 1:],
                "output_pos_blocks": loc[:, 1:],
                "output_final": g_final,
                "output_pos_final": l_final,
            }
        results["_sims"] = {"sims_all": sims[:, 0], "sims_blocks_all": sims[:, 1:]}
        return results

    def run_batch(self, images: Sequence[np.ndarray]) -> Dict[str, dict]:
        """The dump pass of one batch → per-member raw score dict + the
        shared retrieval sims (see :meth:`finish_batch_dump`)."""
        return self.finish_batch_dump(self.dispatch_batch_dump(images))

    def _score_group(self, flags, trainables, text_feats, feats, aug, scores):
        """One member group's test logits, members on the leading axis."""
        return test_logits_from_features(trainables, text_feats, feats, flags,
                                         precomputed_retrieval=(aug, scores))

    def run_batch_multidispatch(self, images: Sequence[np.ndarray]) -> Dict[str, dict]:
        """The dump dict built another way: the features pass, then one
        scoring pass per member group fetched to the host, and the
        co-occurrence adjustment and block aggregation on the host per member
        — the independent check of :meth:`run_batch`."""
        staged = self.stage_batch_fused(images)
        n, b0 = staged.n_boxes, staged.n_real
        b = staged.batch * (1 if self.mesh is None else self.mesh.world)
        with torch.inference_mode():
            feats, aug, scores = self._image_pass(staged)
            per_model = {}
            for names, flags, _, tr, tf in self._model_groups():
                out = self._score_group(flags, tr, tf, feats, aug, scores)
                # [m, b·n, C]: every rank's rows along the middle axis
                g_all, l_all = self._host(out.logits_global, 1), self._host(out.logits_local, 1)
                for mi, name in enumerate(names):
                    per_model[name] = (g_all[mi], l_all[mi])
            sims = self._host(scores).reshape(b, n, -1)[:b0]
        cooc = None if self.cooccurrence is None else self.cooccurrence.float().cpu()
        results: Dict[str, dict] = {}
        for name in self.models:
            g_flat, l_flat = per_model[name]
            g, loc = g_flat.reshape(b, n, -1)[:b0], l_flat.reshape(b, n, -1)[:b0]
            if self._member_use_freq(self.models[name]):
                loc = adjust_predictions(torch.from_numpy(loc), cooc).numpy()
            output, output_blocks = g[:, 0], g[:, 1:]
            output_pos, output_pos_blocks = loc[:, 0], loc[:, 1:]
            finals = [aggregate_blocks(torch.from_numpy(blocks), self.block_threshold,
                                       self.block_coef, base=torch.from_numpy(base)).numpy()
                      for blocks, base in ((output_blocks, output),
                                           (output_pos_blocks, output_pos))]
            results[name] = {
                "output": output,
                "output_pos": output_pos,
                "output_blocks": output_blocks,
                "output_pos_blocks": output_pos_blocks,
                "output_final": finals[0],
                "output_pos_final": finals[1],
            }
        results["_sims"] = {"sims_all": sims[:, 0], "sims_blocks_all": sims[:, 1:]}
        return results

    def run_batches_fused(self, batches, depth: int = 2):
        """Fused scoring over an iterable of image lists, ``depth`` batches
        dispatched ahead of the one being read."""
        pending = deque()
        for images in batches:
            pending.append(self.dispatch_batch_fused(images))
            if len(pending) >= depth:
                yield self._fetch(pending.popleft())
        while pending:
            yield self._fetch(pending.popleft())

    def run_batches_fused_staged(self, batches, depth: int = 2, stage_ahead: int = 2):
        """Producer-thread variant of :meth:`run_batches_fused`: a background
        thread pulls image batches (driving image decode when ``batches`` is
        lazy), preps and uploads them up to ``stage_ahead`` deep, while the
        calling thread only dispatches compute and reads results."""
        q: "queue.Queue" = queue.Queue(maxsize=max(1, stage_ahead))
        err: list = []
        stop = threading.Event()  # set when the consumer exits for any reason

        def _put(item) -> bool:
            # bounded put that gives up once the consumer is gone
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for images in batches:
                    if stop.is_set() or not _put(self.stage_batch_fused(images)):
                        return
            except BaseException as e:  # re-raised on the consumer thread
                err.append(e)
            finally:
                _put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        pending = deque()
        try:
            while True:
                staged = q.get()
                if staged is None:
                    break
                pending.append(self.dispatch_staged_fused(staged))
                if len(pending) >= depth:
                    yield self._fetch(pending.popleft())
            while pending:
                yield self._fetch(pending.popleft())
        finally:
            stop.set()
            try:  # drain so a producer mid-put can observe `stop` and exit
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=10.0)
        if err:
            raise err[0]
