"""Caption-distillation trainer — the prompt-tuning training loop (counterpart
of leclip_tpu/engine/trainer.py; ref: project/my_code/trainers/
Caption_distill_double.py:565-948 + Dassl dassl/engine/trainer.py):

* one training step covering the loss switch (double_ranking with the
  EMA-KLD ×10000 local term, soft_ce, dbl/ResampleLoss,
  ranking_with_cooccurrence, optional LMPT hinge add-on);
* EMA twin updated with momentum 0.995 BEFORE the teacher forward, the
  reference's `_momentum_update`-inside-forward ordering;
* per-epoch cosine LR (stepped at epoch end), early stop, NaN detection,
  per-epoch prompt-only checkpoints in ``{OUTPUT_DIR}/{name}/`` in the JAX
  package's flax-msgpack format.

One device. The frozen caption branch is encoded once per step under
``no_grad`` and shared by the student and teacher heads: under
``TRAINER.PREC bf16`` it runs the bf16 block kernels on the card
(``TRAIN.fused_captions``), under ``TRAIN.int8_captions`` the W8A8 kernels.
The prompt branch, which carries the gradients, runs the plain math (its
causal attention takes the plain route, as in JAX). Every product of a step
runs in full fp32 where its operands are fp32 (TF32 off, ``device.no_tf32``).

``validate`` scores the held-out caption probe (``TRAIN.probe_holdout``) or
else the dataset's val images through a one-member TTA engine;
``TRAIN.profile_dir`` traces a bounded window of first-epoch steps with
torch.profiler; ``Caption_distill_double_adapter`` (the
:class:`CaptionDistillAdapterTrainer`) encodes the prompts through the
bottleneck adapter of models/adapter.py.

Not ported: the data mesh, multi-process loading and device prefetch
(``TRAIN.prefetch_batches`` raises)."""

from __future__ import annotations

import os
import time
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data.datasets import CaptionDataset, build_dataset
from ..data.loader import CaptionBatcher
from ..device import cast_floating, no_tf32, resolve_device, tree_map
from ..models.clip import CLIPConfig
from ..models.dense_clip import DenseFlags, encode_captions, train_logits_from_features
from ..models.prompt import assemble_prompts, build_prompt_learner, ema_update
from ..ops import losses as L
from ..utils.logging import MetricMeter, profiler_trace
from ..utils.registry import TRAINER_REGISTRY
from .checkpoint import resume_if_exists, save_checkpoint
from .config import Config
from .metrics import MetricsWriter
from .train_state import Optimizer, TrainState, build_optimizer, create_train_state, \
    epoch_lr_schedule


def flags_from_config(cfg: Config) -> DenseFlags:
    return DenseFlags(
        use_evidence=cfg.TRAINER.use_evidence,
        learn_scale=cfg.TRAIN.IF_LEARN_SCALE,
        learn_spatial_scale=cfg.TRAIN.IF_LEARN_spatial_SCALE,
        spatial_scale_text=float(cfg.TRAIN.spatial_SCALE_text),
        spatial_scale_image=float(cfg.TRAIN.spatial_SCALE_image),
    )


def make_train_step(
    clip_params: dict,
    clip_cfg: CLIPConfig,
    constants: dict,
    optimizer: Optimizer,
    flags: DenseFlags,
    loss_name: str = "double_ranking",
    model_kind: str = "DenseCLIP",
    ema: bool = False,
    momentum: float = 0.995,
    co_matrix: Optional[torch.Tensor] = None,
    resample_params=None,
    lmpt: bool = False,
    lmpt_lambda: float = 0.5,
    lmpt_class_counts: Optional[torch.Tensor] = None,
    m_ctx: int = 2,
    caption_q8: Optional[dict] = None,
    caption_fused: bool = False,
    caption_text: Optional[dict] = None,
    adapter: Optional[dict] = None,
    adapter_trainable: bool = False,
) -> Callable:
    """Build the (state, captions, labels) → (state, metrics) step.

    ``caption_q8``: int8 text-tower weights for the FROZEN caption branch
    (TRAIN.int8_captions); ``caption_fused``: the bf16 block kernels there.
    ``caption_text`` is the text tower the caption branch runs (default
    ``clip_params["text"]``; the trainer gives the int8 branch a bf16 copy
    on the card, whose kernels take bf16). The prompt branch keeps
    ``clip_params`` and full precision: the gradients flow through it.
    ``adapter``: the adapter trainer's bottleneck, on the prompt path only;
    with ``adapter_trainable`` the state's params carry it as ``_adapter``
    (``adapter`` then stands only where they do not).

    The returned step takes an optional ``mark(name)`` callback, called at
    the end of each part of the step ("caption", "teacher", "prompt
    forward", "loss", "backward", "optimizer"), with which a caller times
    the parts."""
    device = clip_params["text"]["token_embedding"].device
    caption_clip = {"text": caption_text if caption_text is not None else clip_params["text"]}

    def head(params, caption_feats):
        adp = params.get("_adapter", adapter) if adapter_trainable else adapter
        prompt_params = {k: v for k, v in params.items() if k != "_adapter"}
        out, out_local = train_logits_from_features(clip_params, clip_cfg, prompt_params,
                                                    constants, caption_feats, flags, adapter=adp)
        if model_kind == "CustomCLIP":
            return out, None  # global-only variant (ref CustomCLIP :338-352)
        return out, out_local

    def compute_loss(out, out_local, labels, teacher, captions, params):
        aux: Dict[str, torch.Tensor] = {}
        if loss_name == "double_ranking":
            r_loss = L.ranking_loss(out, labels, scale=1.0, margin=1.0)
            if out_local is not None:
                r_loss = r_loss + L.ranking_loss(out_local, labels, scale=1.0, margin=1.0)
            if teacher is not None:
                t_out, t_local = teacher
                ema_loss = (L.kl_distill_loss(out, t_out)
                            + L.kl_distill_loss(out_local, t_local) * 10000.0)
                aux["r_loss"] = r_loss
                aux["ema_loss"] = ema_loss
                loss = r_loss + ema_loss
            else:
                loss = r_loss
        elif loss_name == "soft_ce":
            loss = L.soft_cross_entropy(out, labels)
        elif loss_name == "dbl":
            loss = L.resample_loss(out, labels, resample_params)
            if out_local is not None:
                loss = loss + L.resample_loss(out_local, labels, resample_params)
        elif loss_name == "ranking_with_cooccurrence":
            loss = L.ranking_loss_with_cooccurrence(out, labels, co_matrix)
            if out_local is not None:
                loss = loss + L.ranking_loss_with_cooccurrence(out_local, labels, co_matrix)
        else:
            raise NotImplementedError(f"loss function {loss_name!r}")
        if lmpt:
            caption_embeds = clip_params["text"]["token_embedding"][captions.long()]
            prompt_embeds = assemble_prompts(params, constants)[0]
            hinge = L.lmpt_hinge_from_embeddings(caption_embeds, prompt_embeds, labels,
                                                 lmpt_class_counts, m_ctx=m_ctx)
            aux["loss_lmpt"] = hinge
            loss = lmpt_lambda * loss + (1.0 - lmpt_lambda) * hinge
        aux["loss"] = loss
        return loss, aux

    def train_step(state: TrainState, captions, labels, mark=None):
        mark = mark or (lambda name: None)
        captions = torch.as_tensor(captions, device=device)
        labels = torch.as_tensor(labels, dtype=torch.float32, device=device)
        with no_tf32():
            caption_feats = encode_captions(caption_clip, clip_cfg, captions, flags,
                                            q8=caption_q8, fused=caption_fused)
            mark("caption")
            teacher = None
            ema_params = state.ema_params
            if ema:
                # momentum update BEFORE the teacher forward (reference ordering)
                with torch.no_grad():
                    ema_params = ema_update(state.ema_params, state.params, momentum)
                    teacher = head(ema_params, caption_feats)
            mark("teacher")
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in _flatten(state.params).items()}
            params = _unflatten(leaves)
            out, out_local = head(params, caption_feats)
            mark("prompt forward")
            loss, aux = compute_loss(out, out_local, labels, teacher, captions, params)
            mark("loss")
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            grads = _unflatten({k: torch.zeros_like(v) if g is None else g
                                for (k, v), g in zip(leaves.items(), grads)})
            mark("backward")
            with torch.no_grad():
                new_params, opt_state = optimizer.update(grads, state.opt_state, state.params)
            mark("optimizer")
        metrics = {k: v.detach() for k, v in aux.items()}
        return TrainState(state.step + 1, new_params, ema_params, opt_state), metrics

    return train_step


def _flatten(tree: dict, prefix: tuple = ()) -> dict:
    """{key path: tensor} of a nested dict of tensors."""
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def int8_kernel_stack(text: dict, q8: dict):
    """(text tower, int8 stack) as the card's int8 kernels take them: bf16
    activations, LN affines, biases and out-projection, so the residual
    stream through the stack is bf16 there (fp32 in the JAX package, whose
    kernels keep the input's dtype). The codes and scales, the embeddings,
    ln_final and the projection stay as given."""
    q8 = {**q8, "ln1": cast_floating(q8["ln1"], torch.bfloat16),
          "ln2": cast_floating(q8["ln2"], torch.bfloat16)}
    return {**text, "blocks": cast_floating(text["blocks"], torch.bfloat16)}, q8


@TRAINER_REGISTRY.register(name="Caption_distill_double")
class CaptionDistillTrainer:
    """Owner of dataset, prompt state, optimizer, and the train loop.

    ``device`` defaults to the card (it raises without one); the CPU is used
    only when asked for. The prompt context is drawn from a CPU generator
    seeded with ``cfg.SEED``, so a seed gives the same start on every
    device."""

    def __init__(self, cfg: Config, clip_params: dict, clip_cfg: CLIPConfig,
                 dataset: Optional[CaptionDataset] = None, device=None):
        self.cfg = cfg
        self.clip_cfg = clip_cfg
        self.device = device = resolve_device(device)
        self.dataset = dataset if dataset is not None else build_dataset(cfg)
        self.flags = flags_from_config(cfg)
        self.model_name = cfg.TEST.multi_model[0]
        if cfg.TRAIN.prefetch_batches:
            raise NotImplementedError("TRAIN.prefetch_batches: device prefetch is not ported "
                                      "(each batch is uploaded inline); leave it at 0")

        clip_params = tree_map(lambda t: t.to(device), clip_params)
        self.trainable, self.constants = build_prompt_learner(
            torch.Generator().manual_seed(cfg.SEED), clip_params, self.dataset.classnames,
            n_ctx=cfg.TRAINER.N_CTX, csc=cfg.TRAINER.CSC, ctx_init=cfg.TRAINER.CTX_INIT,
            class_token_position=cfg.TRAINER.CLASS_TOKEN_POSITION,
        )
        if cfg.TRAINER.PREC in ("bf16", "amp-bf16"):
            # frozen towers in bf16; trainable prompt params and LayerNorm
            # statistics stay fp32 (the PREC=fp16/amp analogue, ref
            # Caption_distill_double.py:746-748,795-802)
            clip_params = cast_floating(clip_params, torch.bfloat16)
        self.clip_params = clip_params

        # Labeled accuracy probe: every Nth caption is HELD OUT of training
        # and scored by validate_probe() through the texts-as-images forward.
        tokens = np.asarray(self.dataset.tokens)
        labels = np.asarray(self.dataset.labels)
        self.probe_tokens = self.probe_labels = None
        n_probe = cfg.TRAIN.probe_holdout
        if n_probe > 0 and len(tokens) >= 2 * n_probe:
            hold = np.arange(0, len(tokens), n_probe)
            keep = np.setdiff1d(np.arange(len(tokens)), hold)
            self.probe_tokens = tokens[hold]
            self.probe_labels = labels[hold]
            tokens, labels = tokens[keep], labels[keep]
            print(f"probe holdout: {len(hold)} captions held out of training")
        self.batcher = CaptionBatcher(tokens, labels,
                                      batch_size=cfg.DATALOADER.BATCH_SIZE_TRAIN, seed=cfg.SEED)
        steps = self.batcher.steps_per_epoch()
        self.optimizer = build_optimizer(cfg.OPTIM, steps)
        self.lr_fn = epoch_lr_schedule(cfg.OPTIM, steps)
        self.state = create_train_state(self.trainable, self.optimizer)

        co_matrix = resample_params = lmpt_counts = None
        if cfg.TRAIN.LOSSFUNC == "ranking_with_cooccurrence":
            co_matrix = torch.as_tensor(self._load_cooccurrence(), dtype=torch.float32,
                                        device=device)
        if cfg.TRAIN.LOSSFUNC == "dbl" or cfg.TRAIN.LMPT:
            from ..data.corpora import load_class_freq

            freq = load_class_freq(self.dataset.caption_root, str(cfg.TRAIN.Caption_name))
            resample_params = L.make_resample_loss_params(
                freq["class_freq"], freq["neg_class_freq"], device=device)
            lmpt_counts = torch.as_tensor(freq["class_freq"], dtype=torch.float32,
                                          device=device)

        caption_text = clip_params["text"]
        caption_q8 = None
        if cfg.TRAIN.int8_captions:
            # W8A8 text tower for the FROZEN caption branch only (the prompt
            # branch carries gradients and keeps full precision), quantized
            # from the tower as given, as the JAX package does
            from ..ops.quant import quantize_stack_on_device

            if clip_cfg.transformer_width > 512:
                warnings.warn(
                    f"TRAIN.int8_captions at text width {clip_cfg.transformer_width}: the "
                    "real-geometry gate measured 768-wide causal text outside the ±0.2 "
                    "probe-mAP bound (quant_gate_realwidth.json) — prefer the fused bf16 "
                    "caption branch for >512-wide towers")
            caption_q8 = quantize_stack_on_device(caption_text["blocks"])
            if device.type == "cuda":
                caption_text, caption_q8 = int8_kernel_stack(caption_text, caption_q8)
        # fused bf16 caption branch: where the kernels run (the card), with
        # bf16 frozen towers and no int8 override
        caption_fused = (cfg.TRAIN.fused_captions and caption_q8 is None
                         and device.type == "cuda"
                         and caption_text["blocks"]["ln_1"]["scale"].dtype == torch.bfloat16)
        self.caption_route = "int8" if caption_q8 is not None else (
            "bf16" if caption_fused else "plain")

        self._step_kwargs = dict(
            loss_name=cfg.TRAIN.LOSSFUNC, model_kind=cfg.TRAIN.MODEL,
            ema=cfg.TRAIN.ema, momentum=cfg.TRAIN.momentum,
            co_matrix=co_matrix, resample_params=resample_params,
            lmpt=cfg.TRAIN.LMPT, lmpt_lambda=cfg.TRAIN.LMPT_LAMBDA,
            lmpt_class_counts=lmpt_counts, m_ctx=cfg.TRAINER.M_CTX,
            caption_q8=caption_q8, caption_fused=caption_fused, caption_text=caption_text,
        )
        self.train_step = make_train_step(self.clip_params, clip_cfg, self.constants,
                                          self.optimizer, self.flags, **self._step_kwargs)

    def caption_features(self, captions):
        """The frozen caption branch of a step on this trainer's route (what
        ``train_step`` computes before its heads)."""
        kw = self._step_kwargs
        with no_tf32():
            return encode_captions({"text": kw["caption_text"]}, self.clip_cfg,
                                   torch.as_tensor(captions, device=self.device), self.flags,
                                   q8=kw["caption_q8"], fused=kw["caption_fused"])

    def _load_cooccurrence(self) -> np.ndarray:
        """Row-normalised P(j|i) for the ranking_with_cooccurrence loss: a
        `freq_stats.pkl` next to the caption corpora if there is one, else
        the counts of this dataset's own training labels."""
        from ..data.freq_stats import build_freq_stats, load_freq_stats
        from ..ops.ensemble import normalized_cooccurrence

        root = str(getattr(self.dataset, "caption_root", "") or ".")
        path = os.path.join(root, "freq_stats.pkl")
        if os.path.exists(path):
            stats = load_freq_stats(path)
        else:
            stats = build_freq_stats(np.asarray(self.dataset.labels))
        adj = np.asarray(stats["adj"], np.float64) + 1e-12  # keeps all row sums positive
        nums = np.maximum(np.asarray(stats["nums"], np.float64), 1.0)
        return normalized_cooccurrence(adj, nums).astype(np.float32)

    # ------------------------------ loop ------------------------------------

    def train(self, resume: bool = True) -> TrainState:
        cfg = self.cfg
        start_epoch = 0
        if resume and cfg.RESUME:
            self.state, start_epoch = resume_if_exists(self.state, cfg.RESUME, self.model_name)
        meter = MetricMeter()
        writer = MetricsWriter(cfg.OUTPUT_DIR) if cfg.OUTPUT_DIR else None
        t_start = time.time()
        # Host-sync cadence (TRAIN.sync_every; 0 = auto): fetching the
        # metrics is the step's only sync, so on the card it happens at
        # PRINT_FREQ boundaries and the host queues the steps between; NaN
        # detection lags by at most that many steps. The CPU syncs each step.
        print_freq = max(cfg.TRAIN.PRINT_FREQ, 1)
        sync_every = cfg.TRAIN.sync_every
        if sync_every <= 0:
            sync_every = print_freq if self.device.type == "cuda" else 1
        # Bounded profiler window (TRAIN.profile_dir): the first epoch's
        # steps after [1, min(5, last)] (step 0 pays the first use of every
        # kernel and library), written as a TensorBoard-loadable trace
        self._prof_cm = None
        try:
            self._train_epochs(start_epoch, meter, writer, sync_every, print_freq)
        finally:
            # an exception inside the window (the NaN guard) still closes
            # the profiler, so a later window in the process can open
            if self._prof_cm is not None:
                self._prof_cm.__exit__(None, None, None)
                self._prof_cm = None
            if writer is not None:
                writer.close()
        print(f"training done in {time.time() - t_start:.1f}s")
        return self.state

    def _train_epochs(self, start_epoch, meter, writer, sync_every, print_freq):
        cfg = self.cfg
        max_epoch = cfg.OPTIM.MAX_EPOCH
        steps_per_epoch = self.batcher.steps_per_epoch()
        profiling = bool(cfg.TRAIN.profile_dir)
        prof_start = 1 if steps_per_epoch > 1 else 0
        prof_stop = min(5, steps_per_epoch - 1) if steps_per_epoch > 1 else 0
        for epoch in range(start_epoch, max_epoch):
            t_epoch = time.time()
            for i, batch in enumerate(self.batcher.epoch(epoch)):
                self.state, metrics = self.train_step(self.state, batch["img"], batch["label"])
                if profiling and epoch == start_epoch:
                    if i == prof_start:
                        self._prof_cm = profiler_trace(cfg.TRAIN.profile_dir)
                        self._prof_cm.__enter__()
                    if i == prof_stop and self._prof_cm is not None:
                        if self.device.type == "cuda":
                            torch.cuda.synchronize(self.device)
                        self._prof_cm.__exit__(None, None, None)
                        self._prof_cm = None
                n = i + 1
                if not (n % sync_every == 0 or n % print_freq == 0 or n == steps_per_epoch):
                    continue
                host = {k: float(v) for k, v in metrics.items()}
                if not np.isfinite(host["loss"]):
                    raise FloatingPointError(f"non-finite loss at epoch {epoch}: {host}")
                if n % print_freq == 0:
                    meter.update(host)
                    lr = float(self.lr_fn(self.state.step - 1))
                    print(f"epoch [{epoch + 1}/{max_epoch}] batch [{n}/{steps_per_epoch}] "
                          f"lr {lr:.2e} {meter}")
                    if writer is not None:
                        writer.write_scalars(host, self.state.step, prefix="train/")
                        writer.write_scalar("train/lr", lr, self.state.step)
            # reference save gate (Caption_distill_double.py:576-587): every
            # CHECKPOINT_FREQ epochs (freq<=0 disables the cadence) OR the
            # true last epoch, which saves even at freq<=0; early-stopped
            # epochs past the last freq multiple are NOT saved, as there
            meet_freq = cfg.TRAIN.CHECKPOINT_FREQ > 0 and (
                (epoch + 1) % cfg.TRAIN.CHECKPOINT_FREQ == 0)
            if meet_freq or epoch + 1 == max_epoch:
                path = save_checkpoint(self.state, cfg.OUTPUT_DIR, self.model_name, epoch)
                print(f"checkpoint → {path} ({time.time() - t_epoch:.1f}s/epoch)")
            if 0 <= cfg.TRAIN.early_stop_epoch <= epoch + 1:
                print(f"early stop at epoch {epoch + 1}")
                break

    def validate_probe(self, batch_size: int = 256) -> dict:
        """Score the held-out labeled caption probe (TRAIN.probe_holdout) with
        the CURRENT prompt params through the texts-as-images forward and
        return the evaluator's results (real mAP)."""
        from .evaluator import MLClassificationEvaluator

        if self.probe_tokens is None:
            print("validate probe: TRAIN.probe_holdout is 0 — no probe split")
            return {}
        evaluator = MLClassificationEvaluator(self.cfg.TRAINER.GL_merge_rate)
        n = len(self.probe_tokens)
        bs = min(batch_size, n)
        prompt_params = {k: v for k, v in self.state.params.items() if k != "_adapter"}
        adp = self.state.params.get("_adapter", getattr(self, "adapter", None))
        with torch.no_grad(), no_tf32():
            for i in range(0, n, bs):
                chunk = torch.as_tensor(self.probe_tokens[i:i + bs], device=self.device)
                feats = encode_captions(self.clip_params, self.clip_cfg, chunk, self.flags)
                out, out_local = train_logits_from_features(
                    self.clip_params, self.clip_cfg, prompt_params, self.constants, feats,
                    self.flags, adapter=adp)
                evaluator.process(out.float().cpu().numpy(), self.probe_labels[i:i + bs],
                                  out_local.float().cpu().numpy())
        res = evaluator.evaluate()
        print(f"validate probe ({n} held-out captions): {res}")
        return res

    def validate(self, max_images: int = 64, batch_size: int = 8) -> dict:
        """Post-training validation (the reference's after_train final test
        / val smoke split, dassl trainer.py:415-436): with TRAIN.probe_holdout
        set, the held-out caption probe (real mAP); otherwise the val images
        (``test[::100]``, the first ``max_images``) scored with the CURRENT
        prompt params by a one-member TTA engine (TEST.multi_scale, crops at
        the tower's resolution, no caption bank) in batches of
        ``batch_size``, as the JAX package does. On the unlabeled competition
        split the labels are zeros, so mAP is 0 by construction: the pass
        exercises the whole inference path. As in the JAX package, an
        adapter trainer's image pass scores without its adapter."""
        if self.probe_tokens is not None:
            return self.validate_probe()
        from ..data.loader import ImageBatcher
        from ..inference.tta import TTAEngine, build_model_spec
        from .evaluator import MLClassificationEvaluator

        val_images = self.dataset.val_images[:max_images]
        if not val_images:
            print("validate: no val images available")
            return {}
        prompt_params = {k: v for k, v in self.state.params.items() if k != "_adapter"}
        with no_tf32():
            spec = build_model_spec(self.clip_params, self.clip_cfg, prompt_params,
                                    self.constants, self.flags)
        engine = TTAEngine(self.clip_params, self.clip_cfg, {self.model_name: spec},
                           scales=self.cfg.TEST.multi_scale,
                           crop_size=self.clip_cfg.image_resolution, device=self.device)
        evaluator = MLClassificationEvaluator(self.cfg.TRAINER.GL_merge_rate)
        for images, _ in ImageBatcher(val_images, batch_size):
            out = engine.run_batch(images)[self.model_name]
            labels = np.zeros_like(out["output_final"])
            evaluator.process(out["output_final"], labels, out["output_pos_final"])
        res = evaluator.evaluate()
        print(f"validate ({len(val_images)} images): {res}")
        return res


def build_trainer(cfg: Config, clip_params, clip_cfg, **kwargs):
    """Registry-driven construction (ref dassl/engine/build.py:6-13 reading
    cfg.TRAINER.NAME, set by the launchers' --trainer arg)."""
    name = cfg.TRAINER.NAME or "Caption_distill_double"
    return TRAINER_REGISTRY.get(name)(cfg, clip_params, clip_cfg, **kwargs)


@TRAINER_REGISTRY.register(name="Caption_distill_double_adapter")
class CaptionDistillAdapterTrainer(CaptionDistillTrainer):
    """Adapter trainer variant (ref: trainers/Caption_distill_double_adapter.py
    :463-627): the prompts are encoded through a residual bottleneck text
    adapter (models/adapter.py); the captions go through the plain tower.

    The reference freezes its adapter at random init (only 'prompt_learner'
    params reach the optimizer); TRAINER.adapter_trainable True trains it,
    as ``_adapter`` in the state's params. The adapter is drawn from a CPU
    generator seeded with ``cfg.SEED + 1``, or given as ``adapter``. Its
    step takes the JAX adapter trainer's arguments: the loss switch, the EMA
    teacher and the caption branch's route, but not the co-occurrence,
    resample or LMPT artifacts, which the JAX trainer does not pass on
    either."""

    def __init__(self, cfg: Config, clip_params: dict, clip_cfg: CLIPConfig,
                 dataset: Optional[CaptionDataset] = None, device=None,
                 adapter: Optional[dict] = None):
        super().__init__(cfg, clip_params, clip_cfg, dataset=dataset, device=device)
        from ..models.adapter import init_adapter_params

        if adapter is None:
            adapter = init_adapter_params(torch.Generator().manual_seed(cfg.SEED + 1),
                                          clip_cfg.transformer_width,
                                          cfg.TRAINER.adapter_reduction)
        self.adapter = tree_map(lambda t: t.to(self.device), adapter)
        trainable = dict(self.trainable)
        if cfg.TRAINER.adapter_trainable:
            trainable["_adapter"] = self.adapter
        self.state = create_train_state(trainable, self.optimizer)
        kw = self._step_kwargs
        self._step_kwargs = dict(
            loss_name=kw["loss_name"], model_kind=kw["model_kind"], ema=kw["ema"],
            momentum=kw["momentum"], caption_q8=kw["caption_q8"],
            caption_fused=kw["caption_fused"], caption_text=kw["caption_text"],
            adapter=self.adapter, adapter_trainable=cfg.TRAINER.adapter_trainable)
        self.train_step = make_train_step(self.clip_params, clip_cfg, self.constants,
                                          self.optimizer, self.flags, **self._step_kwargs)
