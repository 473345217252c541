"""The weight bridge (counterpart of leclip_tpu/models/convert.py).

* ``from_jax_params`` / ``to_jax_params`` move a ``leclip_tpu`` parameter
  pytree (numpy leaves, as ``jax.device_get`` returns them) into the port's
  nested dict of tensors and back, value for value: the port keeps the JAX
  layouts ([in, out] kernels, stacked blocks), so nothing is transposed.
  Tuples are kept, so the int8 tree of ``quantize_block_stack`` ((int8,
  fp32 scale) leaves) crosses too; ``from_jax_q8`` also puts its int8 weights
  into the kernel layout of ops/quant.py.
* ``load_torch_state_dict`` / ``convert_state_dict`` / ``load_clip_weights``
  read OpenAI CLIP checkpoints (ViT image tower and text tower).
* ``load_prompt_checkpoint`` reads reference ``model.pth.tar`` prompt files.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .clip import RN_SLICE, CLIPConfig, config_from_state_dict


def _leaf_to_torch(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).astype(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def from_jax_params(tree, device="cpu"):
    """JAX param pytree (nested dicts / tuples of numpy arrays) → port params."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(from_jax_params(v, device) for v in tree)
    return _leaf_to_torch(tree, device)


def from_jax_q8(tree, device="cpu"):
    """A JAX int8 block tree (``leclip_tpu.ops.quant.quantize_block_stack``,
    numpy leaves) → the port's, value for value, int8 weights in the kernel
    layout the CUDA kernels read."""
    from ..device import tree_map
    from ..ops.quant import kernel_layout

    return tree_map(lambda t: kernel_layout(t) if t.dtype == torch.int8 else t,
                    from_jax_params(tree, device))


def to_jax_params(params, bf16_dtype=None):
    """Port params → nested dicts of numpy arrays (the inverse bridge).
    bfloat16 leaves come back as ``bf16_dtype`` (e.g. ml_dtypes.bfloat16,
    same bits) when given, else as exact float32."""
    if isinstance(params, dict):
        return {k: to_jax_params(v, bf16_dtype) for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return tuple(to_jax_params(v, bf16_dtype) for v in params)
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        if bf16_dtype is None:
            return t.float().numpy()
        return t.view(torch.int16).numpy().view(np.uint16).view(bf16_dtype)
    return t.numpy()


# ----------------------------- OpenAI checkpoints -----------------------------


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """OpenAI ``.pt`` (TorchScript archive or plain state dict) → numpy."""
    import warnings

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            model = torch.jit.load(path, map_location="cpu").eval()
        sd = model.state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    for key in ("input_resolution", "context_length", "vocab_size"):
        sd.pop(key, None)
    return {k: _np(v) for k, v in sd.items()}


def _block_stack(sd, prefix: str, layers: int) -> dict:
    """Stack ``prefix.{i}.*`` resblocks on a leading axis, kernels [in, out]."""

    def gather(name, transpose=False):
        return np.stack([sd[f"{prefix}.{i}.{name}"].T if transpose
                         else sd[f"{prefix}.{i}.{name}"] for i in range(layers)])

    return {
        "ln_1": {"scale": gather("ln_1.weight"), "bias": gather("ln_1.bias")},
        "attn": {
            "qkv_kernel": gather("attn.in_proj_weight", True),
            "qkv_bias": gather("attn.in_proj_bias"),
            "out_kernel": gather("attn.out_proj.weight", True),
            "out_bias": gather("attn.out_proj.bias"),
        },
        "ln_2": {"scale": gather("ln_2.weight"), "bias": gather("ln_2.bias")},
        "mlp": {
            "fc_kernel": gather("mlp.c_fc.weight", True),
            "fc_bias": gather("mlp.c_fc.bias"),
            "proj_kernel": gather("mlp.c_proj.weight", True),
            "proj_bias": gather("mlp.c_proj.bias"),
        },
    }


def _convert_vit(sd, n_layers: int) -> dict:
    conv_w = sd["visual.conv1.weight"]  # [width, 3, p, p] → rows in (p, p, c) order
    return {
        "patch_kernel": conv_w.transpose(2, 3, 1, 0).reshape(-1, conv_w.shape[0]),
        "class_embedding": sd["visual.class_embedding"],
        "positional_embedding": sd["visual.positional_embedding"],
        "ln_pre": {"scale": sd["visual.ln_pre.weight"], "bias": sd["visual.ln_pre.bias"]},
        "blocks": _block_stack(sd, "visual.transformer.resblocks", n_layers),
        "ln_post": {"scale": sd["visual.ln_post.weight"], "bias": sd["visual.ln_post.bias"]},
        "proj": sd["visual.proj"],
    }


def convert_state_dict(sd: Dict[str, np.ndarray], device="cpu") -> Tuple[CLIPConfig, dict]:
    """OpenAI-layout state dict (numpy) → (config, port params)."""
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    cfg = config_from_state_dict(sd)
    if not cfg.is_vit:
        raise NotImplementedError(RN_SLICE)
    tree = {
        "visual": _convert_vit(sd, cfg.vision_layers),
        "text": {
            "token_embedding": sd["token_embedding.weight"],
            "positional_embedding": sd["positional_embedding"],
            "blocks": _block_stack(sd, "transformer.resblocks", cfg.transformer_layers),
            "ln_final": {"scale": sd["ln_final.weight"], "bias": sd["ln_final.bias"]},
            "text_projection": sd["text_projection"],
        },
        "logit_scale": np.asarray(sd["logit_scale"], np.float32),
    }
    return cfg, from_jax_params(tree, device)


def load_clip_weights(path: str, device="cpu") -> Tuple[CLIPConfig, dict]:
    """Load an OpenAI CLIP checkpoint file into (config, port params)."""
    return convert_state_dict(load_torch_state_dict(path), device)


_PROMPT_KEYS = (
    "ctx", "ctx_double", "ctx_evidence",
    "temperature", "spatial_T", "ranking_scale",
)


def load_prompt_checkpoint(path: str) -> Tuple[dict, int]:
    """Reference prompt checkpoint (``model.pth.tar[-N]``: ``{"state_dict":
    {ctx, ctx_double, ctx_evidence, temperature, spatial_T, ranking_scale,
    token_* buffers}, "epoch": N, ...}``) → (fp32 trainable tensors, epoch).
    Frozen token buffers are dropped; they are rebuilt from the class list."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    sd = payload.get("state_dict", payload)

    def norm(k: str) -> str:
        for prefix in ("module.", "prompt_learner."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        return k

    sd = {norm(k): v for k, v in sd.items()}
    missing = [k for k in _PROMPT_KEYS if k not in sd]
    if missing:
        raise KeyError(
            f"{path} is not a reference prompt checkpoint (missing {missing}; "
            f"has {sorted(sd)})"
        )
    trainable = {k: torch.as_tensor(sd[k]).detach().float().cpu() for k in _PROMPT_KEYS}
    epoch = int(payload.get("epoch", 0)) if isinstance(payload, dict) else 0
    return trainable, epoch
