"""Layered configuration (the port's own copy of leclip_tpu/engine/config.py):
defaults → dataset YAML → trainer YAML → CLI ``KEY VALUE`` overrides →
freeze, with plain nested dataclasses. PyYAML is imported only when a YAML
file is merged.

Every field of the JAX package's config is kept, so its recipes and CLI
overrides load unchanged; the TPU-specific fields (mesh, prefetch) are read
by nothing in the port. ``resolve_test_precision`` carries the JAX package's
precision rule with a CUDA device standing where that rule says TPU."""

from __future__ import annotations

import ast
import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


@dataclass
class InputConfig:
    SIZE: Tuple[int, int] = (224, 224)
    INTERPOLATION: str = "bicubic"
    PIXEL_MEAN: Tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)
    PIXEL_STD: Tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)
    TRANSFORMS: Tuple[str, ...] = ("random_resized_crop", "random_flip", "normalize")
    TRANSFORMS_TEST: Tuple[str, ...] = ("resize", "center_crop", "normalize")
    random_resized_crop_scale: Tuple[float, float] = (0.6, 1.0)
    cutout_proba: float = 0.4


@dataclass
class DatasetConfig:
    NAME: str = "chatglm_caption_mix"
    ROOT: str = ""
    dataset_select: str = "A"
    caption_feat_root: str = ""


@dataclass
class DataloaderConfig:
    BATCH_SIZE_TRAIN: int = 1024
    BATCH_SIZE_TEST: int = 16
    NUM_WORKERS: int = 8
    SHUFFLE_TRAIN: bool = True


@dataclass
class ModelConfig:
    BACKBONE_NAME: str = "RN50"
    WEIGHTS: str = ""          # path to an OpenAI CLIP .pt / state-dict file
    INIT_WEIGHTS: str = ""     # optional pretrained prompt-learner weights


@dataclass
class OptimConfig:
    NAME: str = "sgd"
    LR: float = 0.01
    WEIGHT_DECAY: float = 5e-4
    MOMENTUM: float = 0.9
    # dassl's optimizer knobs, exact key names incl. the SGD_DAMPNING
    # misspelling (defaults.py:154-158) for KEY VALUE CLI parity
    SGD_DAMPNING: float = 0.0
    SGD_NESTEROV: bool = False
    RMSPROP_ALPHA: float = 0.99
    ADAM_BETA1: float = 0.9
    ADAM_BETA2: float = 0.999
    SCHED: str = "cosine"   # cosine | single_step | multi_step | constant
    STEPSIZE: Tuple[int, ...] = (-1,)  # dassl default (defaults.py:172); <=0 = MAX_EPOCH
    GAMMA: float = 0.1
    MAX_EPOCH: int = 15
    WARMUP_EPOCH: int = 1
    WARMUP_TYPE: str = "linear"  # dassl default (defaults.py:177); every shipped
                                 # recipe with warmup sets "constant" explicitly
    WARMUP_CONS_LR: float = 1e-5
    WARMUP_MIN_LR: float = 1e-5
    # dassl semantics (defaults.py:182): True restarts the annealer at the end
    # of warmup; False lets it resume at epoch index WARMUP_EPOCH (with
    # torch's chained-form phase jump — see epoch_lr_schedule)
    WARMUP_RECOUNT: bool = True


@dataclass
class CaptionTrainerConfig:
    # TRAINER_REGISTRY key (ref TRAINER.NAME via --trainer, train_caption.py:59;
    # the reference default is "" because its launchers always pass it)
    NAME: str = "Caption_distill_double"
    N_CTX: int = 16
    M_CTX: int = 4   # reference default (train_caption.py:99); consumed only by
                     # the LMPT hinge add-on's token-window split (both sides —
                     # ref Caption_distill_double.py:876-879, ours
                     # ops/losses.py lmpt_hinge_loss). Evidence recipes set 2
                     # explicitly; ctx_evidence itself is n_ctx-shaped.
    CSC: bool = False
    CTX_INIT: str = ""
    PREC: str = "fp32"         # fp32 | bf16 | amp-bf16
    CLASS_TOKEN_POSITION: str = "end"
    GL_merge_rate: float = 0.5
    use_evidence: bool = False
    adapter_reduction: int = 4
    adapter_trainable: bool = False  # the reference leaves its adapter frozen


@dataclass
class TrainConfig:
    LOSSFUNC: str = "double_ranking"
    MODEL: str = "DenseCLIP"   # DenseCLIP | CustomCLIP
    Caption_name: str = "ChatGLM_multi_labels_2k_v2"
    ema: bool = False
    momentum: float = 0.995
    hard_data: str = "hard"     # 'hard' | 'soft' | 'total' (ref default "hard",
                                # train_caption.py:123; '' also accepted → hard)
    challenge_data: bool = False
    add_few_shot: bool = False
    add_n2: bool = True     # reference default True (train_caption.py:126);
                            # recipes only ever set it False explicitly
    IF_ablation: bool = False  # plain-variant gate: True → empty train split
                               # (ref pazhou_distill_chatglm.py:66)
    early_stop_epoch: int = 200  # ref default (train_caption.py:127) — it IS
                                 # load-bearing: rn50.yaml's MAX_EPOCH 20000 run
                                 # stops at epoch 200 via this default (dassl
                                 # trainer.py:404). Negative disables.
    CHECKPOINT_FREQ: int = 1
    PRINT_FREQ: int = 5
    sync_every: int = 0         # host-sync (metrics fetch + NaN check) every
                                # N steps; 0 = auto: PRINT_FREQ on the card
                                # (the host queues the steps between), 1 on
                                # the CPU
    prefetch_batches: int = 0   # the JAX package's device-prefetch depth;
                                # the port uploads each batch inline and
                                # raises for any other value
    IF_LEARN_SCALE: bool = False
    IF_LEARN_spatial_SCALE: bool = False
    spatial_SCALE_text: float = 50.0
    spatial_SCALE_image: float = 40.0
    LMPT: bool = False
    LMPT_LAMBDA: float = 0.5
    int8_captions: bool = False  # W8A8 text tower for the frozen caption
                                 # branch (~1.5x); prompt branch stays fp
    fused_captions: bool = True  # bf16 block kernels for the frozen caption
                                 # branch (ops/block_kernels.py); effective on
                                 # the card with PREC bf16 only, superseded by
                                 # int8_captions
    profile_dir: str = ""       # when set, trace first-epoch steps after
                                # 1..5 with torch.profiler into this dir
    # Hold out every Nth training caption as a LABELED accuracy probe
    # (0 = off). The competition val split is unlabeled (mAP always 0), so
    # this held-out texts-as-images split is the only way a training run can
    # show real mAP motion without competition data. Scored by
    # trainer.validate().
    probe_holdout: int = 0


@dataclass
class TestConfig:
    SPLIT: str = "test"
    NO_TEST: bool = False
    EVALUATOR: str = "MLClassification"
    EVALUATOR_ACT: str = "default_merge_aux"
    multi_model: Tuple[str, ...] = ("prompt_learner",)
    multi_scale: Tuple[int, ...] = (2, 3, 4)
    save_pth: bool = False
    save_name: str = "./data.pth"  # ref default (train_caption.py:134)
    use_freq: bool = False
    retrieval_topk: int = 10
    retrieval_merge: bool = True
    PREC: str = "auto"         # inference compute: auto | fp32 | bf16 | int8.
                               # 'auto' resolves per backbone and device
                               # (resolve_test_precision): int8 for a gate-
                               # validated ViT on CUDA, else bf16; the
                               # reference runs fp32 (clip_model.float()) —
                               # set PREC fp32 for reference parity.
    block_fuse_coef: float = 1.4
    block_threshold: float = 0.3
    FINAL_MODEL: str = "last_step"


@dataclass
class Config:
    INPUT: InputConfig = field(default_factory=InputConfig)
    DATASET: DatasetConfig = field(default_factory=DatasetConfig)
    DATALOADER: DataloaderConfig = field(default_factory=DataloaderConfig)
    MODEL: ModelConfig = field(default_factory=ModelConfig)
    OPTIM: OptimConfig = field(default_factory=OptimConfig)
    TRAINER: CaptionTrainerConfig = field(default_factory=CaptionTrainerConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    OUTPUT_DIR: str = "./output"
    RESUME: str = ""
    SEED: int = 1
    eval_only: bool = False
    _frozen: bool = dataclasses.field(default=False, repr=False)

    # ---- layered-merge API -------------------------------------------------

    def clone(self) -> "Config":
        c = copy.deepcopy(self)
        object.__setattr__(c, "_frozen", False)
        return c

    def freeze(self) -> "Config":
        object.__setattr__(self, "_frozen", True)
        return self

    def __setattr__(self, key, value):
        if getattr(self, "_frozen", False):
            raise AttributeError("Config is frozen")
        object.__setattr__(self, key, value)

    def merge_dict(self, d: dict, prefix: str = "") -> "Config":
        for k, v in d.items():
            path = f"{prefix}{k}"
            node, leaf = self._resolve(path)
            if isinstance(v, dict) and dataclasses.is_dataclass(getattr(node, leaf, None)):
                self.merge_dict(v, prefix=path + ".")
            else:
                # yacs decodes YAML strings via literal_eval (its
                # _decode_cfg_value) — how the reference's unquoted
                # ``LR: 1e-5`` / ``SIZE: (224, 224)`` become float/tuple
                # (PyYAML leaves both as str). Only for non-string-typed
                # fields, so names/paths stay raw.
                if isinstance(v, str) and not isinstance(getattr(node, leaf, None), str):
                    v = _parse_literal(v)
                _set_typed(node, leaf, v)
        return self

    def merge_yaml(self, path: str) -> "Config":
        import yaml

        with open(path) as f:
            d = yaml.safe_load(f) or {}
        return self.merge_dict(d)

    def merge_opts(self, opts: Optional[List[str]]) -> "Config":
        """Free-form ``KEY VALUE KEY VALUE …`` overrides with dotted keys."""
        if not opts:
            return self
        if len(opts) % 2 != 0:
            raise ValueError(f"opts must be KEY VALUE pairs, got {opts}")
        for key, raw in zip(opts[::2], opts[1::2]):
            node, leaf = self._resolve(key)
            _set_typed(node, leaf, _parse_literal(raw))
        return self

    def _resolve(self, dotted: str):
        parts = dotted.split(".")
        node: Any = self
        for p in parts[:-1]:
            if not hasattr(node, p):
                raise KeyError(f"Unknown config section {p!r} in {dotted!r}")
            node = getattr(node, p)
        if not hasattr(node, parts[-1]):
            raise KeyError(f"Unknown config key {dotted!r}")
        return node, parts[-1]

    def to_dict(self) -> dict:
        def conv(obj):
            if dataclasses.is_dataclass(obj):
                return {
                    f.name: conv(getattr(obj, f.name))
                    for f in dataclasses.fields(obj)
                    if not f.name.startswith("_")
                }
            if isinstance(obj, tuple):
                return list(obj)
            return obj

        return conv(self)


def _parse_literal(raw: Any) -> Any:
    if not isinstance(raw, str):
        return raw
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def _set_typed(node: Any, leaf: str, value: Any) -> None:
    current = getattr(node, leaf)
    if isinstance(current, tuple) and isinstance(value, (list, tuple)):
        value = tuple(value)
    elif isinstance(current, bool) and isinstance(value, str):
        value = value.lower() in ("true", "1", "yes")
    elif isinstance(current, float) and isinstance(value, int):
        value = float(value)
    if getattr(node, "_frozen", False):
        raise AttributeError("Config is frozen")
    object.__setattr__(node, leaf, value)


# Vision-tower widths whose int8 (W8A8) accuracy passed the JAX package's
# task-level gate at real geometry (quant_gate_realwidth.json: vision 768x12
# PASS). The port inherits that licence because its int8 arithmetic matches
# the JAX kernels' (tests/test_torch_quant_kernels.py). ViT-L's 1024-wide
# tower has no task-level gate and its 768-wide text tower breached the
# bound, so ViT-L 'auto' stays bf16; an explicit int8 remains available.
GATE_VALIDATED_INT8_VISION_WIDTHS = frozenset({768})


def resolve_test_precision(prec: str, clip_cfg, device) -> str:
    """Resolve TEST.PREC for a backbone on a device — the single owner of the
    precision / backbone / device rules.

    'auto' → int8 (the W8A8 kernels) for a ViT whose vision width is
    gate-validated (GATE_VALIDATED_INT8_VISION_WIDTHS) and a multiple of 128,
    on a CUDA device; bf16 otherwise (ResNet towers, ViT-L, the CPU, where
    the plain int8 versions are only a reference). 'fp32' and 'bf16' as
    given. An explicit 'int8' the engine would reject or crawl through (a
    non-ViT backbone, a width that is no multiple of 128, the CPU) degrades
    to bf16 with a warning; on a ViT the kernels take (e.g. ViT-L) on CUDA it
    is honoured — the caller owns the accuracy risk. ``device`` is a
    ``torch.device`` or its name; resolving needs no card."""
    if prec not in ("auto", "fp32", "bf16", "int8"):
        raise ValueError(f"TEST.PREC must be auto | fp32 | bf16 | int8, got {prec!r}")
    kind = getattr(device, "type", None) or str(device).split(":")[0]
    is_vit = getattr(clip_cfg, "is_vit", False)
    int8_ok = is_vit and clip_cfg.vision_width % 128 == 0 and kind == "cuda"
    if prec == "auto":
        return ("int8" if int8_ok and clip_cfg.vision_width in GATE_VALIDATED_INT8_VISION_WIDTHS
                else "bf16")
    if prec == "int8" and not int8_ok:
        import warnings

        warnings.warn(
            "TEST.PREC int8 needs a ViT backbone with 128-multiple width on a CUDA device "
            f"(got {'ViT' if is_vit else 'ResNet'} width "
            f"{getattr(clip_cfg, 'vision_width', '?')} on {kind!r}) — falling back to bf16"
        )
        return "bf16"
    return prec


def default_config() -> Config:
    return Config()


def setup_config(
    dataset_yaml: str = "",
    trainer_yaml: str = "",
    opts: Optional[List[str]] = None,
    **kwargs,
) -> Config:
    """Layered merge in reference order, then freeze."""
    cfg = default_config()
    if dataset_yaml:
        cfg.merge_yaml(dataset_yaml)
    if trainer_yaml:
        cfg.merge_yaml(trainer_yaml)
    for k, v in kwargs.items():
        node, leaf = cfg._resolve(k)
        _set_typed(node, leaf, v)
    cfg.merge_opts(opts)
    return cfg.freeze()
