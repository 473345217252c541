"""leclip_tpu_torch — the PyTorch / CUDA port of ``leclip_tpu`` for NVIDIA
H100 GPUs.

Same subpackage layout as ``leclip_tpu`` (models/, ops/, inference/,
engine/, data/, parallel/, cli/), so each module's counterpart carries the
same name. The port imports torch, numpy and the standard library only; the
JAX package is its reference and is never imported here. Hand-written Hopper
kernels live in ``csrc/`` and are built with nvcc on first use into
``_build/``.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a card they raise instead of falling back. Several
cards run one process each over torch.distributed (``parallel/``; launch
with ``torchrun``).

Top-level convenience names (submodules stay importable directly), the JAX
package's table, each pointing at the port's module of the same name:

    from leclip_tpu_torch import tokenize, PRESETS, TTAEngine
"""

__version__ = "0.1.0"

# name: (module under leclip_tpu_torch, attribute). Random augmentations take
# a torch.Generator where the JAX package takes a key.
_NAMES = {
    "tokenize": ("data.tokenizer", "tokenize"),
    "get_tokenizer": ("data.tokenizer", "get_tokenizer"),
    "COCO_OBJECT_CATEGORIES": ("data.vocab", "COCO_OBJECT_CATEGORIES"),
    "CaptionLabeler": ("data.labeling", "CaptionLabeler"),
    "CLIPConfig": ("models.clip", "CLIPConfig"),
    "PRESETS": ("models.clip", "PRESETS"),
    "init_clip_params": ("models.clip", "init_clip_params"),
    "load_clip_weights": ("models.convert", "load_clip_weights"),
    "build_prompt_learner": ("models.prompt", "build_prompt_learner"),
    "DenseFlags": ("models.dense_clip", "DenseFlags"),
    "dense_train_forward": ("models.dense_clip", "dense_train_forward"),
    "dense_test_forward": ("models.dense_clip", "dense_test_forward"),
    "setup_config": ("engine.config", "setup_config"),
    "CaptionDistillTrainer": ("engine.trainer", "CaptionDistillTrainer"),
    "CLIPFineTuner": ("engine.finetune", "CLIPFineTuner"),
    "TTAEngine": ("inference.tta", "TTAEngine"),
    "build_model_spec": ("inference.tta", "build_model_spec"),
    "run_full_inference": ("inference.pipeline", "run_full_inference"),
    "build_caption_bank": ("inference.pipeline", "build_caption_bank"),
    "make_engine": ("inference.pipeline", "make_engine"),
    "load_ensemble_specs": ("inference.pipeline", "load_ensemble_specs"),
    "load_prompt_checkpoint": ("models.convert", "load_prompt_checkpoint"),
    "ScoringService": ("cli.serve", "ScoringService"),
    "multihost_initialize": ("parallel.multihost", "initialize"),
    "is_primary": ("parallel.multihost", "is_primary"),
    "generate_final_answers": ("ops.ensemble", "generate_final_answers"),
    "randaugment": ("ops.randaugment", "randaugment"),
    "autoaugment": ("ops.autoaugment", "autoaugment"),
    "gcn_forward": ("models.gcn", "gcn_forward"),
    "init_gcn_params": ("models.gcn", "init_gcn_params"),
    "quantize_block_stack": ("ops.quant", "quantize_block_stack"),
    "int8_matmul": ("ops.quant", "int8_matmul"),
}


def __getattr__(name):
    # lazy: `import leclip_tpu_torch` stays light (no torch import)
    if name in _NAMES:
        import importlib

        module, attr = _NAMES[name]
        return getattr(importlib.import_module(f"{__name__}.{module}"), attr)
    raise AttributeError(f"module 'leclip_tpu_torch' has no attribute {name!r}")
