"""Dual-encoder CLIP fine-tuning (counterpart of leclip_tpu/engine/finetune.py,
"BASELINE config 4": ViT-B/16 and RN101 fine-tuned on image-caption pairs).

Unlike prompt tuning (frozen towers, a small trainable tree), this trains
the whole dual encoder: symmetric InfoNCE over (image, caption) pairs with
the learnable logit_scale clamped at log(100), global-norm clipping, then
AdamW on a warmup-cosine schedule with no decay on norms, biases and
embeddings. ``fit_pairs`` consumes a ``data.loader.PairBatcher``: the host
decodes and bucket-pads the JPEGs, the train transform
(ops/preprocess.py ``preprocess_train_batch``) runs on the device inside
the step, metrics go to JSONL, and each epoch writes
``{dir}/{name}/model.ckpt-{e}`` in the JAX package's layout, which both
packages resume from.

One process per GPU over a ``parallel.mesh.DataMesh`` (the initialized
process group's world, else one rank on ``device``: ``"cpu"`` for the CPU,
the card otherwise). Each rank steps on its own rows of the global batch;
the loss is over the global batch, as in the JAX package: the image and
text features are gathered with their gradient
(``parallel.mesh.gather_with_grad``), the gradient is averaged over the
ranks before the global-norm clip, and each rank takes its own rows of the
global batch's augmentation draws, so world 2 augments as world 1 does.
Persistence, metric files and console lines are rank 0's. ``prefetch > 0``
uploads the next batches from a producer thread. On the card, ViT
attention takes the JAX package's "auto" route, ``resident_attention`` in
every layer of the image tower, under autograd (its backward recomputes the
plain form). Several backbones (ViT-B/16 and RN101) run one fine-tuner each
over the same pair stream.

The optimizer is written on tensors as engine/train_state.py writes the
prompt trainer's, so its state is the optax chain's in flax's state-dict
form, leaf for leaf::

    {"0": {},                                   # clip_by_global_norm
     "1": {"0": {"count", "mu", "nu"},          # adamw: scale_by_adam
           "1": {"inner_state": {}},            #   masked add_decayed_weights
           "2": {"count"}}}                     #   scale_by_learning_rate

and the learning rate is optax's ``warmup_cosine_decay_schedule(0, lr,
warmup, total)`` (whose ``decay_steps`` counts the warmup) in float32 on the
host."""

from __future__ import annotations

import math
import os
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.mesh import DataMesh, all_reduce_mean, data_mesh, gather_with_grad, \
    prefetch_sharded, replicate
from ..parallel.multihost import is_primary
from ..models.clip import CLIPConfig, clip_encode_image, clip_encode_text
from ..models.convert import from_jax_params, to_jax_params
from . import flax_msgpack
from .train_state import _F32, Optimizer, _adam_moments, _bias, _cos, _count, _scaled, _tree, _zeros

MAX_LOGIT_SCALE = float(np.log(100.0))
_DECAY_SKIP = ("bias", "scale", "mean", "var", "embedding", "logit_scale")


class FinetuneState(NamedTuple):
    step: int
    params: dict
    opt_state: dict


def clip_contrastive_loss(params: dict, clip_cfg: CLIPConfig, images: torch.Tensor,
                          tokens: torch.Tensor, impl: str = "auto", remat: bool = False,
                          mesh: Optional[DataMesh] = None):
    """Symmetric InfoNCE over in-batch pairs (the CLIP pre-training loss):
    (loss, logits [B, B]). Under a ``mesh`` each rank encodes its own rows
    and the pairs are the global batch's, every rank's features gathered
    with their gradient."""
    img = clip_encode_image(params, clip_cfg, images, impl=impl)
    txt = clip_encode_text(params, clip_cfg, tokens, impl=impl, remat=remat)
    img = img / img.norm(dim=-1, keepdim=True)
    txt = txt / txt.norm(dim=-1, keepdim=True)
    if mesh is not None:
        img, txt = gather_with_grad(img, mesh), gather_with_grad(txt, mesh)
    scale = params["logit_scale"].clamp(max=MAX_LOGIT_SCALE).exp()
    logits = scale * img @ txt.t()
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss = 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels))
    return loss, logits


def multilabel_finetune_loss(params: dict, clip_cfg: CLIPConfig, images: torch.Tensor,
                             class_text_feats: torch.Tensor, labels: torch.Tensor,
                             impl: str = "auto"):
    """Supervised multi-label objective: BCE of the image features against
    fixed class prompt features → (loss, logits [B, C])."""
    img = clip_encode_image(params, clip_cfg, images, impl=impl)
    img = img / img.norm(dim=-1, keepdim=True)
    logits = 4.0 * img @ class_text_feats.t()
    bce = logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    return bce.mean(), logits


# ------------------------------- optimizer -----------------------------------


def warmup_cosine_schedule(peak: float, warmup_steps: int,
                           total_steps: int) -> Callable[[int], np.float32]:
    """optax's ``warmup_cosine_decay_schedule(0, peak, warmup_steps,
    total_steps)`` in float32, operation for operation: a linear rise from 0
    over ``warmup_steps``, then ``peak · ½(1 + cos(π t / (total − warmup)))``
    for t steps after the warmup, held at 0 past the end."""
    decay = total_steps - warmup_steps
    if decay <= 0:
        raise ValueError(f"total_steps {total_steps} must exceed warmup_steps {warmup_steps}")

    def lr(count: int) -> np.float32:
        count = int(count)
        if count < warmup_steps:
            frac = _F32(1.0) - _F32(max(count, 0)) / _F32(warmup_steps)
            return _F32(-peak) * frac + _F32(peak)
        t = _F32(min(count - warmup_steps, decay))
        cosine = _F32(0.5) * (_F32(1.0) + _cos(_F32(math.pi) * t / _F32(decay)))
        return _F32(peak) * cosine

    return lr


def decay_mask(params: dict, _path: str = "") -> dict:
    """True where AdamW decays a leaf: every tensor of two or more axes
    whose path (the keys joined by "/", lower case) names no bias, scale,
    BN statistic, embedding or the logit scale (the JAX package's
    ``_decay_mask``)."""
    if isinstance(params, dict):
        return {k: decay_mask(v, f"{_path}/{k}".lower()) for k, v in params.items()}
    return not any(t in _path for t in _DECAY_SKIP) and params.dim() >= 2


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (optax's ``global_norm``)."""
    leaves = []
    _tree(leaves.append, tree)
    return torch.sqrt(sum(g.float().square().sum() for g in leaves))


def finetune_optimizer(lr: float, weight_decay: float, warmup_steps: int, total_steps: int,
                       mask: dict, max_norm: float = 1.0) -> Optimizer:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(schedule,
    weight_decay, mask=mask))`` on tensors: the gradient scaled by
    ``max_norm / ‖g‖`` when its global norm reaches ``max_norm``, Adam's
    bias-corrected moments (b1 0.9, b2 0.999, eps 1e-8), ``weight_decay · p``
    added where ``mask``, and the step ``−lr(count) · u``."""
    schedule = warmup_cosine_schedule(lr, warmup_steps, total_steps)
    b1, b2, eps = 0.9, 0.999, 1e-8

    def init(params: dict) -> dict:
        adam = {"count": _count(), "mu": _zeros(params), "nu": _zeros(params)}
        return {"0": {}, "1": {"0": adam, "1": {"inner_state": {}}, "2": {"count": _count()}}}

    def update(grads: dict, state: dict, params: dict):
        g_norm = global_norm(grads)
        keep = g_norm < max_norm  # decided on the device: no wait for the host
        grads = _tree(lambda g: torch.where(keep, g, (g / g_norm.to(g.dtype)) * max_norm), grads)
        st = state["1"]["0"]
        mu, nu = _adam_moments(grads, st["mu"], st["nu"], b1, b2)
        count = st["count"] + 1
        bc1, bc2 = _bias(b1, int(count)), _bias(b2, int(count))
        u = _tree(lambda m, v: (m / float(bc1)) / (torch.sqrt(v / float(bc2)) + eps), mu, nu)
        u = _tree(lambda ui, p, m: ui + weight_decay * p if m else ui, u, params, mask)
        lr_count = state["1"]["2"]["count"]
        new = _scaled(u, -schedule(int(lr_count)), params)
        return new, {"0": {}, "1": {"0": {"count": count, "mu": mu, "nu": nu},
                                    "1": {"inner_state": {}},
                                    "2": {"count": lr_count + 1}}}

    return Optimizer(init, update)


# --------------------------------- tuner --------------------------------------


def _take_rows(tree, rows: slice):
    """``rows`` of every tensor of a nested (named) tuple of draws."""
    if isinstance(tree, torch.Tensor):
        return tree[rows]
    if hasattr(tree, "_fields"):
        return type(tree)(*(_take_rows(v, rows) for v in tree))
    return type(tree)(_take_rows(v, rows) for v in tree)


class CLIPFineTuner:
    """Full-model fine-tuner over a data mesh: ``train_step`` on prepared
    images, ``fit`` over such batches, ``fit_pairs`` over a PairBatcher with
    the augmentation on the device, and ``save`` / ``resume``. ``mesh``
    defaults to ``parallel.mesh.data_mesh(device)``; each rank passes its
    own rows of the global batch."""

    def __init__(self, clip_params: dict, clip_cfg: CLIPConfig, lr: float = 1e-5,
                 weight_decay: float = 0.2, warmup_steps: int = 100, total_steps: int = 10_000,
                 remat: bool = True, attention_impl: str = "auto", device=None,
                 mesh: Optional[DataMesh] = None):
        self.mesh = mesh if mesh is not None else data_mesh(device)
        self.device = self.mesh.device
        self.clip_cfg = clip_cfg
        # a copy on the device, rank 0's on every rank
        params = replicate(_tree(lambda t: t.detach().to(self.device).clone(), clip_params),
                           self.mesh)
        self.mask = decay_mask(params)
        self.optimizer = finetune_optimizer(lr, weight_decay, warmup_steps, total_steps,
                                            self.mask)
        self.state = FinetuneState(0, params, self.optimizer.init(params))
        self._impl = attention_impl
        self._remat = remat

    # ------------------------------ steps ------------------------------------

    def _loss_and_grads(self, params: dict, images: torch.Tensor, tokens: torch.Tensor):
        with torch.enable_grad():
            live = _tree(lambda t: t.detach().requires_grad_(), params)
            flat = []
            _tree(flat.append, live)
            loss, logits = clip_contrastive_loss(
                live, self.clip_cfg, images, tokens, impl=self._impl, remat=self._remat,
                mesh=self.mesh if self.mesh.distributed else None)
            grads = torch.autograd.grad(loss, flat)
        # the global loss's gradient: the mean of the ranks' (each rank's
        # rows carry the world's summed cotangent, gather_with_grad)
        it = iter(all_reduce_mean(grads, self.mesh))
        labels = torch.arange(logits.shape[0], device=logits.device)
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return loss.detach(), acc, _tree(lambda _: next(it), params)

    def _apply(self, state: FinetuneState, images, tokens):
        loss, acc, grads = self._loss_and_grads(state.params, images, tokens)
        with torch.no_grad():
            params, opt_state = self.optimizer.update(grads, state.opt_state, state.params)
        return FinetuneState(state.step + 1, params, opt_state), {
            "loss": loss, "acc": acc, "grad_norm": global_norm(grads)}

    def train_step(self, state: FinetuneState, images, tokens):
        """One step on normalised images [B, H, W, 3] and tokens [B, 77]
        (tensors or arrays, moved to the tuner's device; under a mesh this
        rank's rows of the global batch) → (new state, {"loss", "acc",
        "grad_norm"} as device scalars of the global batch; grad_norm is the
        gradient's global norm before clipping)."""
        images = torch.as_tensor(images, device=self.device)
        tokens = torch.as_tensor(tokens, device=self.device)
        return self._apply(state, images, tokens)

    def raw_train_step(self, state: FinetuneState, seed: int, images_u8, content, tokens):
        """One step on a bucket-padded uint8 batch: a generator on the device
        seeded with ``seed`` draws the train transform's parameters for the
        global batch, of which this rank applies its own rows' with
        ``preprocess_train_batch`` on the device."""
        from ..ops.preprocess import preprocess_train_batch, sample_train

        images_u8 = torch.as_tensor(images_u8, device=self.device)
        content = torch.as_tensor(content, device=self.device)
        tokens = torch.as_tensor(tokens, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        size = self.clip_cfg.image_resolution
        b, mesh = images_u8.shape[0], self.mesh
        draws = sample_train(gen, (b * mesh.world,), size, device=self.device)
        if mesh.world > 1:
            draws = _take_rows(draws, slice(mesh.rank * b, (mesh.rank + 1) * b))
        images = preprocess_train_batch(images_u8, content, draws, size=size)
        return self._apply(state, images, tokens)

    # --------------------------- persistence ----------------------------------

    def save(self, directory: str, name: str = "clip_finetune", epoch: int = 0) -> str:
        """``{directory}/{name}/model.ckpt-{epoch}``: params, optimizer state,
        step and epoch in the JAX package's layout, beside the
        ``checkpoint`` pointer. Every rank holds the same state: callers
        under a mesh save on rank 0 (``fit_pairs`` does)."""
        model_dir = os.path.join(directory, name)
        os.makedirs(model_dir, exist_ok=True)
        path = os.path.join(model_dir, f"model.ckpt-{epoch}")
        payload = {"params": to_jax_params(self.state.params),
                   "opt_state": to_jax_params(self.state.opt_state),
                   "step": int(self.state.step), "epoch": epoch}
        with open(path, "wb") as f:
            f.write(flax_msgpack.packb(payload))
        with open(os.path.join(model_dir, "checkpoint"), "w") as f:
            f.write(os.path.basename(path))
        return path

    def resume(self, directory: str, name: str = "clip_finetune") -> int:
        """Restore the newest checkpoint if there is one; returns the epoch
        to start from."""
        from .checkpoint import _like, latest_checkpoint, load_checkpoint

        path = latest_checkpoint(directory, name)
        if path is None:
            return 0
        payload = load_checkpoint(path)
        params = _like(self.state.params, from_jax_params(payload["params"]))
        opt = _like(self.state.opt_state, from_jax_params(payload["opt_state"]))
        self.state = FinetuneState(int(payload.get("step", 0)), params, opt)
        return int(payload.get("epoch", -1)) + 1

    # ------------------------------- loops ------------------------------------

    def _sync_cadence(self, sync_every: int, log_every: int) -> int:
        """0 = auto: on the card, read the metrics at log boundaries only
        (each read waits for the device); per step on the CPU."""
        if sync_every > 0:
            return sync_every
        return max(log_every, 1) if self.device.type == "cuda" else 1

    @staticmethod
    def _drain_metrics(pending, writer, where: str):
        for step, m in pending:
            loss = float(m["loss"])
            if not np.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at {where}")
            if writer is not None:
                writer.write_scalars({"loss": loss, "acc": float(m["acc"])}, step,
                                     prefix="finetune/")
        last = pending[-1][1]
        pending.clear()
        return float(last["loss"]), float(last["acc"])

    def fit(self, batches, log_every: int = 10, metrics_writer=None, prefetch: int = 0,
            sync_every: int = 0) -> FinetuneState:
        """batches: iterable of {'image': [B, H, W, 3] float, 'tokens':
        [B, 77]}, this rank's rows under a mesh. ``prefetch > 0`` uploads
        the next batches from a producer thread (parallel/mesh.py
        ``prefetch_sharded``); ``sync_every`` (0 = auto) batches the reads
        of the metrics."""
        sync = self._sync_cadence(sync_every, log_every)
        pending = []
        step0 = int(self.state.step)
        for i, b in enumerate(prefetch_sharded(batches, self.mesh, depth=prefetch)):
            self.state, metrics = self.train_step(self.state, b["image"], b["tokens"])
            pending.append((step0 + i + 1, metrics))
            if (i + 1) % sync != 0 and (i + 1) % log_every != 0:
                continue
            loss, acc = self._drain_metrics(pending, metrics_writer, f"step {i}")
            if (i + 1) % log_every == 0 and is_primary():
                print(f"finetune step {i + 1}: loss {loss:.4f} acc {acc:.3f}")
        if pending:
            self._drain_metrics(pending, metrics_writer, "final step")
        return self.state

    def fit_pairs(self, pair_batcher, epochs: int = 1, output_dir: Optional[str] = None,
                  name: str = "clip_finetune", resume: bool = True, seed: int = 0,
                  log_every: int = 10, prefetch: int = 0,
                  sync_every: int = 0) -> FinetuneState:
        """The (image, caption) pipeline: per-epoch shuffled PairBatcher
        batches → the train transform on the device inside each step →
        JSONL metrics → a checkpoint per epoch, resuming from the newest
        one. Step ``i`` of epoch ``e`` draws its augmentation from the seed
        ``(seed·1000003 + e·100000 + i) mod (2³¹ − 1)``.

        Under a mesh the batcher is this rank's shard
        (``PairBatcher(shard_index=rank, num_shards=world)``; duplicated data
        would give each caption world − 1 identical negatives), every rank
        resumes from the shared directory, and rank 0 alone writes the
        metrics, the checkpoints and the console lines."""
        mesh = self.mesh
        if (getattr(pair_batcher, "shard_index", 0), getattr(pair_batcher, "num_shards", 1)) != (
                mesh.rank, mesh.world):
            raise ValueError(f"fit_pairs on rank {mesh.rank} of {mesh.world} needs the pair "
                             f"batcher's shard {mesh.rank} of {mesh.world}")
        primary = is_primary()
        writer = None
        start_epoch = 0
        if output_dir:
            from .metrics import MetricsWriter

            if primary:
                writer = MetricsWriter(output_dir)
            if resume:
                start_epoch = self.resume(output_dir, name)
                if start_epoch and primary:
                    print(f"resumed {name} at epoch {start_epoch} (step {self.state.step})")
        sync = self._sync_cadence(sync_every, log_every)
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            pending = []
            step0 = int(self.state.step)
            for i, b in enumerate(prefetch_sharded(pair_batcher.epoch(epoch), mesh,
                                                   depth=prefetch)):
                step_seed = (seed * 1_000_003 + epoch * 100_000 + i) % (2 ** 31 - 1)
                self.state, metrics = self.raw_train_step(
                    self.state, step_seed, b["image_u8"], b["content"], b["tokens"])
                pending.append((step0 + i + 1, metrics))
                if (i + 1) % sync != 0 and (i + 1) % log_every != 0:
                    continue
                loss, _ = self._drain_metrics(pending, writer, f"epoch {epoch} step {i}")
                if (i + 1) % log_every == 0 and primary:
                    print(f"epoch {epoch} step {i + 1}: loss {loss:.4f}")
            if pending:
                self._drain_metrics(pending, writer, f"epoch {epoch} final step")
            if output_dir and primary:
                self.save(output_dir, name, epoch)
                writer.flush()
            if primary:
                print(f"epoch {epoch} done in {time.time() - t0:.1f}s")
        if writer is not None:
            writer.close()
        return self.state
