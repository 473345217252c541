"""Operations and bytes of the port's work, counted from shapes, and the
card's published peaks: the yardstick of every roofline and mfu share.

Peaks are NVIDIA's H100 SXM data sheet, dense, at the card's full 700 W
power limit: 989 TFLOP/s bf16, 1,979 TOP/s int8, 67 TFLOP/s fp32 outside the
tensor cores (TF32 stays off), 3.35 TB/s of HBM3. A card set below 700 W
runs slower under load; the result line names the card, and PERF.md gives
each share with the card's power limit beside it.

``conv_work`` and ``rn_tower_flops`` are copies of chip_smoke.py's, and the
block formulas follow PERF.md's kernel table; each counts the work the
inputs need (an operation is a multiply or an add: 2 per multiply-add; each
input and output byte moved once), not what an implementation does on top
(padding to a bucket, pad tokens, the full square of a causal mask)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

PEAK_FLOPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12


def bound_s(ops: float, nbytes: float, dtype: str) -> float:
    """The least time of a piece of work on the card: its operations at the
    dtype's peak or its bytes at the memory's, whichever is longer."""
    return max(ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


# ------------------------------------ RN50 ------------------------------------------


def conv_work(x_shape, k_shape, stride, elem=2):
    """(operations, bytes) of one convolution: 2 per multiply-add over
    K = kh*kw*Cin; input, weight and output each moved once, ``elem`` bytes
    an element (2 bf16, 4 fp32)."""
    b, h, w, cin = x_shape
    cout, _, kh, kw = k_shape
    m = b * -(-h // stride) * -(-w // stride)
    return 2.0 * m * cout * kh * kw * cin, elem * (b * h * w * cin + cout * kh * kw * cin
                                                   + m * cout)


def rn_convs(cfg: dict, batch: int) -> List[Tuple[tuple, tuple, int, bool]]:
    """The stem and trunk's convolutions as the port runs them on ``batch``
    crops: (input NHWC shape, kernel [out, in, kh, kw] shape, stride, whether
    the call adds a residual). RN50: 3 + 16 * 3 + 4 = 55."""
    width, res = cfg["vision_width"], cfg["image_resolution"]
    out = [((batch, res, res, 3), (width // 2, 3, 3, 3), 2, False)]
    h = res // 2
    out.append(((batch, h, h, width // 2), (width // 2, width // 2, 3, 3), 1, False))
    out.append(((batch, h, h, width // 2), (width, width // 2, 3, 3), 1, False))
    h //= 2
    cin = width
    for i, n in enumerate(cfg["vision_layers"]):
        planes = width * 2 ** i
        cout = 4 * planes
        for j in range(n):
            stride = 2 if (j == 0 and i > 0) else 1
            ho = h // stride
            if stride > 1 or cin != cout:
                out.append(((batch, ho, ho, cin), (cout, cin, 1, 1), 1, False))
            out.append(((batch, h, h, cin), (planes, cin, 1, 1), 1, False))
            out.append(((batch, h, h, planes), (planes, planes, 3, 3), 1, False))
            out.append(((batch, ho, ho, planes), (cout, planes, 1, 1), 1, True))
            h, cin = ho, cout
    return out


def rn_trunk_bound_s(cfg: dict, batch: int, elem: int = 2, dtype: str = "bf16") -> float:
    """Sum over the stem and trunk's convolutions of each call's least time
    (a fused call also reads its residual)."""
    total = 0.0
    for x, k, stride, residual in rn_convs(cfg, batch):
        ops, nbytes = conv_work(x, k, stride, elem)
        if residual:
            b, h, w, _ = x
            nbytes += elem * b * h * w * k[0]
        total += bound_s(ops, nbytes, dtype)
    return total


def rn_tower_flops(cfg: dict, res: int = 224) -> float:
    """Operations of one crop through the ResNet tower as the scoring path
    runs it: the 3-conv stem, every bottleneck's convs (1x1 and 3x3 at the
    block's input grid, the last 1x1 and the downsample after the
    anti-aliasing pool), the single-query pool (k, v over the H*W + 1
    tokens, q and c_proj over one) and the dense projection (v_proj, c_proj
    at every position)."""
    w = cfg["vision_width"]
    h = res // 2
    f = 2 * h * h * 9 * (3 * (w // 2) + (w // 2) * (w // 2) + (w // 2) * w)
    h //= 2
    cin = w
    for i, n in enumerate(cfg["vision_layers"]):
        planes = w * 2 ** i
        cout = 4 * planes
        for b in range(n):
            stride = 2 if (b == 0 and i > 0) else 1
            ho = h // stride
            f += 2 * h * h * (cin * planes + 9 * planes * planes) + 2 * ho * ho * planes * cout
            if stride > 1 or cin != cout:
                f += 2 * ho * ho * cin * cout
            h, cin = ho, cout
    e, t = w * 32, h * h + 1
    f += 2 * (2 * t + 1) * e * e + 2 * e * cfg["embed_dim"] + 4 * t * e
    f += 2 * h * h * (e * e + e * cfg["embed_dim"])
    return float(f)


# ------------------------------------ ViT -------------------------------------------


def vit_tokens(cfg: dict) -> int:
    grid = cfg["image_resolution"] // cfg["vision_patch_size"]
    return grid * grid + 1


def int8_layer_work(rows: int, seqs: int, t: int, d: int, h: int) -> Dict[str, tuple]:
    """One ViT layer on the W8A8 route, per kernel: (int8 operations, bf16
    operations, bytes). ``rows`` = seqs * t; score pairs t * t a sequence.
    ``attn_block_int8``: 6RD^2 int8 (QKV), 2RD^2 + 4 seqs D t^2 bf16 (out
    projection, logits, PV), 4RD + 5D^2 bytes; ``mlp_int8``: 4RDH int8, 4RD
    + 2DH bytes; ``ln_quant`` (twice a layer): 3RD + 4R bytes."""
    r = rows
    return {"attn_block_int8": (6.0 * r * d * d, 2.0 * r * d * d + 4.0 * seqs * d * t * t,
                                4.0 * r * d + 5.0 * d * d),
            "mlp_int8": (4.0 * r * d * h, 0.0, 4.0 * r * d + 2.0 * d * h),
            "ln_quant": (0.0, 0.0, 2 * (3.0 * r * d + 4.0 * r))}


def vit_blocks_bound_s(cfg: dict, crops: int) -> float:
    """The least time of the ViT's layers on the W8A8 route for ``crops``
    crops: each kernel's operations at the int8 and bf16 peaks, or its
    bytes, whichever is longer, summed over the layers."""
    t, d = vit_tokens(cfg), cfg["vision_width"]
    total = 0.0
    for i8, b16, nbytes in int8_layer_work(crops * t, crops, t, d, 4 * d).values():
        total += max(i8 / PEAK_FLOPS["int8"] + b16 / PEAK_FLOPS["bf16"], nbytes / PEAK_BYTES)
    return total * cfg["vision_layers"]


def vit_tower_ops(cfg: dict) -> Dict[str, float]:
    """Operations of one crop through the ViT tower on the W8A8 route, by
    the dtype they run in: the patch embedding, ln and projections bf16, the
    blocks' QKV and MLP products int8, the attention and out projection
    bf16."""
    t, d, e = vit_tokens(cfg), cfg["vision_width"], cfg["embed_dim"]
    p = cfg["vision_patch_size"]
    layers = cfg["vision_layers"]
    int8 = layers * (6.0 * t * d * d + 4.0 * t * d * 4 * d)
    bf16 = (2.0 * (t - 1) * p * p * 3 * d + layers * (2.0 * t * d * d + 4.0 * d * t * t)
            + 2.0 * t * d * e)
    return {"int8": int8, "bf16": bf16}


# ---------------------------------- scoring path ------------------------------------


def resize_flops(sides: Sequence[float], out: int = 224) -> float:
    """The separable bicubic resize of square crops of the given sides to
    out x out x 3, at the taps the cubic needs (4, widened by the shrink
    factor): a rows pass over the crop's columns, then a columns pass."""
    total = 0.0
    for s in sides:
        taps = 4.0 * max(s / out, 1.0)
        total += 2.0 * (out * taps * s * 3 + out * out * 3 * taps)
    return total


def retrieval_flops(crops: int, bank_rows: int, dim: int) -> float:
    return 2.0 * crops * bank_rows * dim


def scoring_flops(cfg: dict, crops: int, positions: int) -> float:
    """Every member's global logits (2 E C a crop) and local logits (2 P E C
    a crop, twice with evidence prompts)."""
    e, c = cfg["embed_dim"], len(cfg["classnames"])
    total = 0.0
    for m in cfg["members"]:
        total += crops * (2.0 * e * c + (4.0 if m["evidence"] else 2.0) * positions * e * c)
    return total


def score_batch_ideal_s(cfg: dict, sides: Sequence[float], route: str) -> float:
    """The least time of one scored batch, whose crops have the given
    sides: each operation at the peak of the dtype it runs in (resize, retrieval and scoring fp32; the tower bf16, or
    int8 and bf16 on the W8A8 route)."""
    crops = len(sides)
    t = resize_flops(sides, cfg["image_resolution"]) / PEAK_FLOPS["fp32"]
    if cfg["vision_patch_size"]:
        ops = vit_tower_ops(cfg)
        if route == "int8":
            t += crops * (ops["int8"] / PEAK_FLOPS["int8"] + ops["bf16"] / PEAK_FLOPS["bf16"])
        else:
            t += crops * (ops["int8"] + ops["bf16"]) / PEAK_FLOPS[route]
        positions = vit_tokens(cfg) - 1
    else:
        t += crops * rn_tower_flops(cfg, cfg["image_resolution"]) / PEAK_FLOPS[route]
        positions = (cfg["image_resolution"] // 32) ** 2
    t += retrieval_flops(crops, cfg["bank_rows"], cfg["embed_dim"]) / PEAK_FLOPS["fp32"]
    t += scoring_flops(cfg, crops, positions) / PEAK_FLOPS["fp32"]
    return t


# --------------------------------- training step ------------------------------------


def text_forward_flops(seqs: int, t: int, d: int, layers: int, e: int,
                       project_all: bool) -> Tuple[float, float]:
    """(dense-layer operations, attention operations) of the causal text
    tower's forward over ``seqs`` sequences of ``t`` tokens: per layer QKV,
    out projection and the 4x MLP (24 t d^2 a sequence), and the logits and
    PV over the causal pairs (4 d t(t+1)/2); the projection at every position
    (``project_all``) or at the EOT only."""
    dense = seqs * layers * 24.0 * t * d * d + seqs * 2.0 * d * e * (t if project_all else 1)
    attn = seqs * layers * 4.0 * d * t * (t + 1) / 2
    return dense, attn


def train_step_flops(cfg: dict, batch: int, n_ctx_sets: int, evidence: bool) -> float:
    """Operations of one caption-distillation step: the frozen caption branch
    (every position projected), the student's prompt features forward and
    backward (backward through the frozen tower to the context vectors: the
    dense products once more, the attention products twice), the EMA
    teacher's forward, and the logits of both heads."""
    t, d, e = cfg["context_length"], cfg["transformer_width"], cfg["embed_dim"]
    layers, c = cfg["transformer_layers"], len(cfg["classnames"])
    cap_dense, cap_attn = text_forward_flops(batch, t, d, layers, e, True)
    sets = n_ctx_sets + (1 if evidence else 0)
    p_dense, p_attn = text_forward_flops(sets * c, t, d, layers, e, False)
    prompt = 2 * (p_dense + p_attn) + (p_dense + 2 * p_attn)   # student fwd, teacher fwd, bwd
    # each head's global and local logits; the student's backward to its
    # prompt features costs its forward again
    head = batch * (2.0 * e * c + 2.0 * t * e * c * (2 if evidence else 1))
    return cap_dense + cap_attn + prompt + 3 * head
