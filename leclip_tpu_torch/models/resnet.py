"""ModifiedResNet (CLIP RN50 family), NHWC (counterpart of
leclip_tpu/models/resnet.py): the 3-conv stem with its average pool,
anti-aliased strided bottlenecks (average pool before the strided 1x1), and
the attention-pool head, whose global output is the image embedding. As in
the JAX package, ``if_pos=False`` skips the positional embedding and a grid
other than the trained one gets a bicubic-resized positional embedding.

Layouts. Activations are NHWC at every public function, as in the JAX
package; ``F.conv2d`` takes them as NCHW views with channels-last strides
(``permute`` costs nothing). Conv weights are kept in ``F.conv2d``'s
[out, in, kh, kw] order with channels-last strides (:func:`conv_layout`),
converted once from the JAX package's HWIO when the weights are loaded
(models/convert.py), never per call; the bottlenecks after the first of a
stage are stacked on a leading axis as in the JAX tree, and run in a loop.

Numerics follow the JAX functions: convolutions pad "SAME" the way
``lax.conv_general_dilated`` does, which for the stride-2 3x3 stem on an
even input is (0, 1), not the (1, 1) of OpenAI's ModifiedResNet (a hazard of
the reference, kept here so that the two packages agree); batch norm is the
inference affine ``x * scale + offset`` with both computed in fp32 from the
running statistics and cast to the activations' dtype, not folded into the
conv weights; the pool's logits and softmax are fp32, and its probabilities
are cast to v's dtype before the second product. An fp32 tower runs its
convolutions and products in full fp32 (TF32 off inside the call, see
device.no_tf32). The tower holds no hand-written kernel: the convolutions
are cuDNN's, as the JAX package leaves them to XLA, and the 50-token pool is
plain PyTorch, as in JAX."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..device import no_tf32 as _no_tf32
from ..device import tree_map
from ..ops.attention import _matmul, _mm32, attention_core
from ..ops.resize_matmul import cubic_kernel

_BN_EPS = 1e-5


def conv_layout(w: torch.Tensor) -> torch.Tensor:
    """A conv weight [..., out, in, kh, kw] with channels-last strides
    (stored as [..., out, kh, kw, in]), the layout cuDNN reads beside NHWC
    activations. Leading axes (stacked bottlenecks) are kept."""
    n = w.dim() - 4
    lead = list(range(n))
    stored = w.permute(*lead, n, n + 2, n + 3, n + 1).contiguous()
    return stored.permute(*lead, n, n + 3, n + 1, n + 2)


def from_hwio(w: torch.Tensor) -> torch.Tensor:
    """JAX's HWIO conv kernel [..., kh, kw, in, out] → :func:`conv_layout`."""
    n = w.dim() - 4
    return conv_layout(w.permute(*range(n), n + 3, n + 2, n, n + 1))


def to_hwio(w: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`from_hwio`, as a contiguous tensor."""
    n = w.dim() - 4
    return w.permute(*range(n), n + 2, n + 3, n + 1, n).contiguous()


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of ``lax.conv_general_dilated(padding="SAME")``:
    the output keeps ceil(size / stride) positions and an odd total pads one
    more after."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x [B, H, W, Cin] → [B, H', W', Cout], padded "SAME" as the JAX conv
    pads (asymmetric pads, such as the stem's (0, 1), by an explicit pad);
    ``kernel`` [Cout, Cin, kh, kw], cast to x's dtype."""
    kh, kw = kernel.shape[-2:]
    (top, bottom), (left, right) = (_same_pads(x.shape[1], kh, stride),
                                    _same_pads(x.shape[2], kw, stride))
    xc = x.permute(0, 3, 1, 2)
    w = kernel.to(x.dtype)
    if top == bottom and left == right:
        y = F.conv2d(xc, w, stride=stride, padding=(top, left))
    else:
        y = F.conv2d(F.pad(xc, (left, right, top, bottom)), w, stride=stride)
    return y.permute(0, 2, 3, 1)


def batch_norm(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Inference batch norm: the running statistics as an affine, computed
    in fp32 and cast to x's dtype."""
    scale = p["scale"].float() * torch.rsqrt(p["var"].float() + _BN_EPS)
    offset = p["bias"].float() - p["mean"].float() * scale
    return x * scale.to(x.dtype) + offset.to(x.dtype)


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    if window <= 1:
        return x
    return F.avg_pool2d(x.permute(0, 3, 1, 2), window).permute(0, 2, 3, 1)


def bottleneck(x: torch.Tensor, p: dict, stride: int) -> torch.Tensor:
    """conv1x1-bn-relu → conv3x3-bn-relu → avgpool(stride) → conv1x1-bn,
    with an avgpool + conv1x1 + bn shortcut when the shape changes."""
    out = torch.relu(batch_norm(conv2d(x, p["conv1"]), p["bn1"]))
    out = torch.relu(batch_norm(conv2d(out, p["conv2"]), p["bn2"]))
    out = avg_pool(out, stride)
    out = batch_norm(conv2d(out, p["conv3"]), p["bn3"])
    if "downsample" in p:
        identity = avg_pool(x, stride)
        identity = batch_norm(conv2d(identity, p["downsample"]["conv"]), p["downsample"]["bn"])
    else:
        identity = x
    return torch.relu(out + identity)


def run_stage(x: torch.Tensor, stage: dict, stride: int) -> torch.Tensor:
    """block0, then each of the stacked ``rest`` blocks in turn."""
    x = bottleneck(x, stage["block0"], stride)
    rest = stage.get("rest")
    if rest is not None:
        for i in range(rest["conv1"].shape[0]):
            x = bottleneck(x, tree_map(lambda t: t[i], rest), 1)
    return x


def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """[n_in, n_out] weights of ``jax.image.resize(..., "bicubic")`` along one
    axis: Keys cubic a = -0.5 at half-pixel centres, its support widened by
    the shrink factor (antialiasing) when n_out < n_in, columns normalised,
    and zero where a sample falls outside the input."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = cubic_kernel(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def interpolate_pos_embedding(pos: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bicubic-resize the grid part of the (N² + 1, C) positional embedding
    to (h, w), as ``jax.image.resize(..., "bicubic")`` does (antialiased when
    it shrinks); identity when the grid already matches."""
    n = pos.shape[0] - 1
    side = math.isqrt(n)
    if h == w and h * w == n:
        return pos
    grid = pos[1:].reshape(side, side, -1)
    if h != side:
        grid = torch.einsum("ih,ijc->hjc", _resize_weights(side, h).to(pos), grid)
    if w != side:
        grid = torch.einsum("jw,hjc->hwc", _resize_weights(side, w).to(pos), grid)
    return torch.cat([pos[:1], grid.reshape(h * w, -1)], dim=0)


def _proj(y: torch.Tensor, p: dict) -> torch.Tensor:
    return y @ p["kernel"].to(y.dtype) + p["bias"].to(y.dtype)


def attention_pool(feat: torch.Tensor, p: dict, n_heads: int, if_pos: bool = True,
                   global_only: bool = False
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """QKV attention pool over a [B, H, W, C] map with the spatial mean
    prepended as a query token: (global [B, out], map [B, H, W, out]).
    ``global_only`` computes only the mean token's attention row (the same
    global output; the dense path projects the trunk map itself, see
    :func:`project_dense`) and returns (global, None). The full map runs
    through :func:`attention_core`, whose "auto" route is the plain math at
    this length, as in the JAX package (which passes no ``impl`` here)."""
    b, h, w, c = feat.shape
    x = feat.reshape(b, h * w, c)
    x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)  # [B, HW + 1, C]
    if if_pos:
        x = x + interpolate_pos_embedding(p["positional_embedding"], h, w)[None].to(x.dtype)
    t = x.shape[1]
    hd = c // n_heads
    with _no_tf32():
        if global_only:
            q = _proj(x[:, :1], p["q_proj"]).reshape(b, 1, n_heads, hd)
            k = _proj(x, p["k_proj"]).reshape(b, t, n_heads, hd)
            v = _proj(x, p["v_proj"]).reshape(b, t, n_heads, hd)
            logits = _mm32((q * hd ** -0.5).permute(0, 2, 1, 3), k.permute(0, 2, 3, 1))
            probs = torch.softmax(logits, dim=-1)                        # [B, H, 1, T] fp32
            out = _matmul(probs.to(v.dtype), v.permute(0, 2, 1, 3))      # [B, H, 1, hd]
            out = _proj(out.permute(0, 2, 1, 3).reshape(b, 1, c), p["c_proj"])
            return out[:, 0], None

        def heads(y):
            return y.reshape(b, t, n_heads, hd).transpose(1, 2)

        q, k, v = (_proj(x, p[name]) for name in ("q_proj", "k_proj", "v_proj"))
        out = attention_core(heads(q), heads(k), heads(v))
        out = _proj(out.transpose(1, 2).reshape(b, t, c), p["c_proj"])
    return out[:, 0], out[:, 1:].reshape(b, h, w, -1)


def project_dense(feature_map: torch.Tensor, p: dict) -> torch.Tensor:
    """Per-position v_proj → c_proj of a [B, H, W, C] map → [B, H*W, out]:
    the dense features of the scoring path."""
    b, h, w, c = feature_map.shape
    with _no_tf32():
        return _proj(_proj(feature_map.reshape(b, h * w, c), p["v_proj"]), p["c_proj"])


def resnet_features(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Images [B, H, W, 3] → the layer4 map [B, H/32, W/32, width·32]."""
    with _no_tf32():
        for i in (1, 2, 3):
            x = torch.relu(batch_norm(conv2d(x, params[f"conv{i}"], stride=2 if i == 1 else 1),
                                      params[f"bn{i}"]))
        x = avg_pool(x, 2)
        for i, stride in zip((1, 2, 3, 4), (1, 2, 2, 2)):
            x = run_stage(x, params[f"layer{i}"], stride)
    return x


def encode_image_resnet(x: torch.Tensor, params: dict, n_heads: int, dense: bool = False,
                        if_pos: bool = True, pool_map: bool = True):
    """Images → global [B, E]; with ``dense`` (global, pool map or None,
    trunk map). ``pool_map=False`` (dense callers that project the trunk map
    themselves) and the non-dense path use the single-query pool."""
    feat = resnet_features(x, params)
    g, fmap = attention_pool(feat, params["attnpool"], n_heads, if_pos=if_pos,
                             global_only=(not dense) or (not pool_map))
    if dense:
        return g, fmap, feat
    return g


# ----------------------------------- init -----------------------------------


def init_resnet_params(generator: torch.Generator, layers: Sequence[int], output_dim: int,
                       input_resolution: int = 224, width: int = 64, dtype=torch.float32,
                       device=None) -> dict:
    """Random ModifiedResNet params with the JAX package's init scheme (He
    normal convs, unit BN with every bottleneck's bn3 scale zero, normal
    pool projections of std embed^-0.5), drawn from ``generator``."""

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=device) * std).to(dtype)

    def conv(kh, kw, cin, cout):
        return conv_layout(normal((cout, cin, kh, kw), (2.0 / (kh * kw * cin)) ** 0.5))

    def bn(c, zero_scale=False):
        return {"scale": (torch.zeros if zero_scale else torch.ones)(c, dtype=dtype,
                                                                      device=device),
                "bias": torch.zeros(c, dtype=dtype, device=device),
                "mean": torch.zeros(c, dtype=torch.float32, device=device),
                "var": torch.ones(c, dtype=torch.float32, device=device)}

    def block(cin, planes, stride):
        cout = planes * 4
        p = {"conv1": conv(1, 1, cin, planes), "bn1": bn(planes),
             "conv2": conv(3, 3, planes, planes), "bn2": bn(planes),
             "conv3": conv(1, 1, planes, cout), "bn3": bn(cout, zero_scale=True)}
        if stride > 1 or cin != cout:
            p["downsample"] = {"conv": conv(1, 1, cin, cout), "bn": bn(cout)}
        return p

    p = {"conv1": conv(3, 3, 3, width // 2), "bn1": bn(width // 2),
         "conv2": conv(3, 3, width // 2, width // 2), "bn2": bn(width // 2),
         "conv3": conv(3, 3, width // 2, width), "bn3": bn(width)}
    cin = width
    for i, (n_blocks, stride) in enumerate(zip(layers, (1, 2, 2, 2)), start=1):
        planes = width * 2 ** (i - 1)
        stage = {"block0": block(cin, planes, stride)}
        cin = planes * 4
        if n_blocks > 1:
            rest = [block(cin, planes, 1) for _ in range(n_blocks - 1)]
            stage["rest"] = _stack(rest)
        p[f"layer{i}"] = stage

    embed = width * 32
    spacial = input_resolution // 32
    std = embed ** -0.5

    def lin(cin_, cout_):
        return {"kernel": normal((cin_, cout_), std),
                "bias": torch.zeros(cout_, dtype=dtype, device=device)}

    p["attnpool"] = {
        "positional_embedding": normal((spacial ** 2 + 1, embed), embed ** -0.5),
        "q_proj": lin(embed, embed), "k_proj": lin(embed, embed),
        "v_proj": lin(embed, embed), "c_proj": lin(embed, output_dim),
    }
    return p


def _stack(blocks: list) -> dict:
    """Bottleneck dicts → one dict of leaves stacked on a leading axis (conv
    weights kept channels-last)."""
    first = blocks[0]
    if isinstance(first, dict):
        return {k: _stack([b[k] for b in blocks]) for k in first}
    out = torch.stack(blocks)
    return conv_layout(out) if out.dim() == 5 else out
