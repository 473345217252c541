"""Plain float32 CLIP towers for the benchmark's reference: OpenAI CLIP's
ModifiedResNet and VisionTransformer image towers and its causal text tower,
written out with plain ``torch`` operations, TF32 off.

The parameters are the nested dicts the benchmark makes (benchmark/weights.py):
transformer layers stacked on a leading axis, ``[in, out]`` linear kernels,
convolution kernels ``[out, in, kh, kw]``. Nothing here imports the program.

Every product of a tower goes through a ``Numerics`` object, which is plain
float32 for the reference and rounds the operands to a lower precision for
the control (benchmark/reference/lowprec.py)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
LN_EPS = 1e-5


class Numerics:
    """Plain float32: each product's operands as they are."""

    name = "fp32"

    def operands(self, a: torch.Tensor, b: torch.Tensor):
        """(a, b) as this precision would hold them before a product;
        ``a``'s rows and ``b``'s columns are the product's outer axes."""
        return a, b

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = self.operands(a.float(), b.float())
        return a @ b

    def conv(self, x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
        """x NCHW, w [out, in, kh, kw], padded as "SAME" pads: the total pad
        split with its smaller half first (the stem's stride-2 3x3 on an even
        grid pads (0, 1))."""
        kh = w.shape[-1]
        pads = []
        for size in (x.shape[-1], x.shape[-2]):
            out = -(-size // stride)
            total = max((out - 1) * stride + kh - size, 0)
            pads += [total // 2, total - total // 2]
        return F.conv2d(*self.conv_operands(F.pad(x, pads), w), stride=stride)

    def conv_operands(self, x: torch.Tensor, w: torch.Tensor):
        """(x, w) as this precision would hold them before a convolution."""
        return x, w


FP32 = Numerics()


def no_tf32():
    """A context with TF32 off for both matmul and cuDNN."""
    class _Ctx:
        def __enter__(self):
            self.saved = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        def __exit__(self, *exc):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
    return _Ctx()


def layer_norm(x: torch.Tensor, p: dict) -> torch.Tensor:
    return F.layer_norm(x.float(), x.shape[-1:], p["scale"].float(), p["bias"].float(),
                        eps=LN_EPS)


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def layer(stacked, i: int):
    """Layer ``i`` of a stacked parameter tree."""
    if isinstance(stacked, dict):
        return {k: layer(v, i) for k, v in stacked.items()}
    return stacked[i]


# ----------------------------------- transformer ------------------------------------


def attention(x: torch.Tensor, p: dict, heads: int, num: Numerics,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head self-attention over [B, T, D] with the packed q | k | v
    projection; ``mask`` is added to the logits."""
    b, t, d = x.shape
    hd = d // heads
    qkv = num.matmul(x, p["qkv_kernel"]) + p["qkv_bias"].float()
    q, k, v = (y.reshape(b, t, heads, hd).transpose(1, 2) for y in qkv.split(d, dim=-1))
    logits = num.matmul(q * hd ** -0.5, k.transpose(-1, -2))
    if mask is not None:
        logits = logits + mask
    out = num.matmul(torch.softmax(logits, dim=-1), v)
    out = out.transpose(1, 2).reshape(b, t, d)
    return num.matmul(out, p["out_kernel"]) + p["out_bias"].float()


def block(x: torch.Tensor, p: dict, heads: int, num: Numerics,
          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pre-LN residual block: attention, then the QuickGELU MLP."""
    x = x + attention(layer_norm(x, p["ln_1"]), p["attn"], heads, num, mask)
    h = num.matmul(layer_norm(x, p["ln_2"]), p["mlp"]["fc_kernel"]) + p["mlp"]["fc_bias"].float()
    h = h * torch.sigmoid(1.702 * h)
    return x + num.matmul(h, p["mlp"]["proj_kernel"]) + p["mlp"]["proj_bias"].float()


def transformer(x: torch.Tensor, blocks: dict, heads: int, num: Numerics,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    for i in range(blocks["ln_1"]["scale"].shape[0]):
        x = block(x, layer(blocks, i), heads, num, mask)
    return x


# ----------------------------------- image towers -----------------------------------


def vit_features(images: torch.Tensor, p: dict, heads: int, patch: int,
                 num: Numerics = FP32):
    """Images [B, H, W, 3] (normalised) → (global [B, E], patch tokens
    [B, P, E]), both projected, neither normalised. Patch embedding is the
    stride-``patch`` convolution written as a product over (py, px, c)."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.float().reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    x = num.matmul(x.reshape(b, gh * gw, patch * patch * c), p["patch_kernel"])
    cls = p["class_embedding"].float().expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + p["positional_embedding"].float()[: gh * gw + 1]
    x = transformer(layer_norm(x, p["ln_pre"]), p["blocks"], heads, num)
    x = layer_norm(x, p["ln_post"])
    y = num.matmul(x, p["proj"])
    return y[:, 0], y[:, 1:]


def _bn(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Inference batch norm over NCHW from the running statistics."""
    scale = p["scale"].float() * torch.rsqrt(p["var"].float() + BN_EPS)
    offset = p["bias"].float() - p["mean"].float() * scale
    return x * scale[:, None, None] + offset[:, None, None]


def _bottleneck(x: torch.Tensor, p: dict, stride: int, num: Numerics) -> torch.Tensor:
    """OpenAI CLIP's anti-aliased bottleneck: 1x1, 3x3, average pool by the
    stride, 1x1; the shortcut an average pool, 1x1 and batch norm where the
    shape changes."""
    pool = (lambda y: F.avg_pool2d(y, stride)) if stride > 1 else (lambda y: y)
    identity = x
    if "downsample" in p:
        identity = _bn(num.conv(pool(x), p["downsample"]["conv"].float(), 1),
                       p["downsample"]["bn"])
    out = torch.relu(_bn(num.conv(x, p["conv1"].float(), 1), p["bn1"]))
    out = torch.relu(_bn(num.conv(out, p["conv2"].float(), 1), p["bn2"]))
    out = _bn(num.conv(pool(out), p["conv3"].float(), 1), p["bn3"])
    return torch.relu(out + identity)


def resnet_trunk(images: torch.Tensor, p: dict, num: Numerics = FP32) -> torch.Tensor:
    """Images [B, H, W, 3] → the layer4 map NCHW [B, 2048, H/32, W/32]."""
    x = images.float().permute(0, 3, 1, 2)
    for i in (1, 2, 3):
        x = torch.relu(_bn(num.conv(x, p[f"conv{i}"].float(), 2 if i == 1 else 1), p[f"bn{i}"]))
    x = F.avg_pool2d(x, 2)
    for i, stride in zip((1, 2, 3, 4), (1, 2, 2, 2)):
        stage = p[f"layer{i}"]
        x = _bottleneck(x, stage["block0"], stride, num)
        rest = stage.get("rest")
        if rest is not None:
            for j in range(rest["conv1"].shape[0]):
                x = _bottleneck(x, layer(rest, j), 1, num)
    return x


def _linear(y: torch.Tensor, p: dict, num: Numerics) -> torch.Tensor:
    return num.matmul(y, p["kernel"]) + p["bias"].float()


def resnet_features(images: torch.Tensor, p: dict, heads: int, num: Numerics = FP32):
    """Images → (global [B, E], dense [B, HW, E]) as the dense scoring path
    takes them: the attention pool's output at the mean token (queries from
    the mean token only, no positional embedding), and every position of the
    trunk map through the pool's v and c projections."""
    fmap = resnet_trunk(images, p, num)
    b, c, h, w = fmap.shape
    x = fmap.permute(0, 2, 3, 1).reshape(b, h * w, c)
    x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
    ap = p["attnpool"]
    hd = c // heads
    q = _linear(x[:, :1], ap["q_proj"], num).reshape(b, 1, heads, hd).transpose(1, 2)
    k = _linear(x, ap["k_proj"], num).reshape(b, -1, heads, hd).transpose(1, 2)
    v = _linear(x, ap["v_proj"], num).reshape(b, -1, heads, hd).transpose(1, 2)
    probs = torch.softmax(num.matmul(q * hd ** -0.5, k.transpose(-1, -2)), dim=-1)
    pooled = num.matmul(probs, v).transpose(1, 2).reshape(b, 1, c)
    g = _linear(pooled, ap["c_proj"], num)[:, 0]
    dense = _linear(_linear(x[:, 1:], ap["v_proj"], num), ap["c_proj"], num)
    return g, dense


# ------------------------------------- text tower -----------------------------------


def causal_mask(n: int, device) -> torch.Tensor:
    return torch.full((n, n), float("-inf"), device=device).triu(1)


def text_hidden(embeds: torch.Tensor, p: dict, heads: int, num: Numerics = FP32) -> torch.Tensor:
    """Token embeddings [N, L, W] → post-ln_final hidden states [N, L, W]."""
    n = embeds.shape[1]
    x = embeds.float() + p["positional_embedding"].float()[:n]
    x = transformer(x, p["blocks"], heads, num, causal_mask(n, x.device))
    return layer_norm(x, p["ln_final"])


def text_eot(embeds: torch.Tensor, eot: torch.Tensor, p: dict, heads: int,
             num: Numerics = FP32) -> torch.Tensor:
    """EOT-position features [N, E], projected, not normalised."""
    x = text_hidden(embeds, p, heads, num)
    x = x[torch.arange(x.shape[0], device=x.device), eot.long()]
    return num.matmul(x, p["text_projection"])


def text_sequence(embeds: torch.Tensor, p: dict, heads: int, num: Numerics = FP32):
    """Every position's projected features [N, L, E], not normalised."""
    return num.matmul(text_hidden(embeds, p, heads, num), p["text_projection"])


def vision_heads(cfg: dict) -> int:
    """OpenAI CLIP's head count: width / 64 for a ViT, width * 32 / 64 for
    the ResNet pool."""
    if cfg["vision_patch_size"]:
        return cfg["vision_width"] // 64
    return cfg["vision_width"] * 32 // 64


def image_features(images: torch.Tensor, visual: dict, cfg: dict, num: Numerics = FP32):
    """(normalised global [B, E], normalised dense [B, P, E])."""
    heads = vision_heads(cfg)
    if cfg["vision_patch_size"]:
        g, d = vit_features(images, visual, heads, cfg["vision_patch_size"], num)
    else:
        g, d = resnet_features(images, visual, heads, num)
    return normalize(g), normalize(d)
