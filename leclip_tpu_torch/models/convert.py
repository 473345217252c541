"""The weight bridge (counterpart of leclip_tpu/models/convert.py).

* ``from_jax_params`` / ``to_jax_params`` move a ``leclip_tpu`` parameter
  pytree (numpy leaves, as ``jax.device_get`` returns them) into the port's
  nested dict of tensors and back, value for value: the port keeps the JAX
  layouts ([in, out] kernels, stacked blocks), so nothing is transposed but
  the ResNet's conv kernels (leaves under ``conv``, ``conv1``..``conv3``):
  JAX's HWIO becomes ``F.conv2d``'s [out, in, kh, kw] with channels-last
  strides on the way in (models/resnet.py ``from_hwio``), and HWIO again on
  the way back. Tuples are kept, so the int8 tree of
  ``quantize_block_stack`` ((int8, fp32 scale) leaves) crosses too;
  ``from_jax_q8`` also puts its int8 weights into the kernel layout of
  ops/quant.py.
* ``load_torch_state_dict`` / ``convert_state_dict`` / ``load_clip_weights``
  read OpenAI CLIP checkpoints (ViT or ResNet image tower, and the text
  tower).
* ``load_prompt_checkpoint`` reads reference ``model.pth.tar`` prompt files.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .clip import CLIPConfig, config_from_state_dict
from .resnet import from_hwio, to_hwio

# keys whose 4-D leaves (5-D when stacked) are ResNet conv kernels
_CONV_KEYS = ("conv", "conv1", "conv2", "conv3")


def _is_conv(key, ndim: int) -> bool:
    return key in _CONV_KEYS and ndim in (4, 5)


def _leaf_to_torch(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).astype(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def from_jax_params(tree, device="cpu", _key=None):
    """JAX param pytree (nested dicts / tuples of numpy arrays) → port params."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device, k) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(from_jax_params(v, device) for v in tree)
    t = _leaf_to_torch(tree, device)
    return from_hwio(t) if _is_conv(_key, t.dim()) else t


def from_jax_q8(tree, device="cpu"):
    """A JAX int8 block tree (``leclip_tpu.ops.quant.quantize_block_stack``,
    numpy leaves) → the port's, value for value, int8 weights in the kernel
    layout the CUDA kernels read."""
    from ..device import tree_map
    from ..ops.quant import kernel_layout

    return tree_map(lambda t: kernel_layout(t) if t.dtype == torch.int8 else t,
                    from_jax_params(tree, device))


def to_jax_params(params, bf16_dtype=None, _key=None):
    """Port params → nested dicts of numpy arrays (the inverse bridge).
    bfloat16 leaves come back as ``bf16_dtype`` (e.g. ml_dtypes.bfloat16,
    same bits) when given, else as exact float32."""
    if isinstance(params, dict):
        return {k: to_jax_params(v, bf16_dtype, k) for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return tuple(to_jax_params(v, bf16_dtype) for v in params)
    t = params.detach().cpu()
    if _is_conv(_key, t.dim()):
        t = to_hwio(t)
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


def _convert_resnet(sd, layers) -> dict:
    """The ModifiedResNet tower in the JAX package's tree (HWIO convs, BN
    {scale, bias, mean, var}, bottlenecks after the first of a stage
    stacked); ``from_jax_params`` then puts the convs in the port's layout."""

    def conv(key):
        return sd[key].transpose(2, 3, 1, 0)  # OIHW → HWIO

    def bn(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"],
                "mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]}

    def linear(prefix):
        return {"kernel": sd[f"{prefix}.weight"].T, "bias": sd[f"{prefix}.bias"]}

    def bottleneck(prefix):
        blk = {"conv1": conv(f"{prefix}.conv1.weight"), "bn1": bn(f"{prefix}.bn1"),
               "conv2": conv(f"{prefix}.conv2.weight"), "bn2": bn(f"{prefix}.bn2"),
               "conv3": conv(f"{prefix}.conv3.weight"), "bn3": bn(f"{prefix}.bn3")}
        if f"{prefix}.downsample.0.weight" in sd:
            blk["downsample"] = {"conv": conv(f"{prefix}.downsample.0.weight"),
                                 "bn": bn(f"{prefix}.downsample.1")}
        return blk

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    p = {}
    for i in (1, 2, 3):
        p[f"conv{i}"] = conv(f"visual.conv{i}.weight")
        p[f"bn{i}"] = bn(f"visual.bn{i}")
    for li, n_blocks in zip((1, 2, 3, 4), layers):
        stage = {"block0": bottleneck(f"visual.layer{li}.0")}
        if n_blocks > 1:
            stage["rest"] = stack([bottleneck(f"visual.layer{li}.{b}")
                                   for b in range(1, n_blocks)])
        p[f"layer{li}"] = stage
    p["attnpool"] = {
        "positional_embedding": sd["visual.attnpool.positional_embedding"],
        **{name: linear(f"visual.attnpool.{name}")
           for name in ("q_proj", "k_proj", "v_proj", "c_proj")},
    }
    return p


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
    tree = {
        "visual": (_convert_vit(sd, cfg.vision_layers) if cfg.is_vit
                   else _convert_resnet(sd, cfg.vision_layers)),
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
