"""Launch counts of every hand-written kernel, in one place. Each wrapper
adds one to its ``launches`` where it launches its kernel and nowhere else;
a run that must show which kernels it went through resets the counts before
and reads them after."""

from __future__ import annotations

from .block_kernels import attn_block_bf16, mlp_bf16
from .flash_attention import flash_attention, resident_attention
from .quant_kernels import attn_block_int8, ln_quant, mlp_int8

WRAPPERS = {
    "attn_block_bf16": attn_block_bf16,
    "mlp_bf16": mlp_bf16,
    "ln_quant": ln_quant,
    "attn_block_int8": attn_block_int8,
    "mlp_int8": mlp_int8,
    "resident_attention": resident_attention,
    "flash_attention": flash_attention,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
