"""VBI-paged decode attention: the Hopper kernel and its plain twin."""
from .ops import build_kernel, paged_attention, paged_decode_attention
from .ref import ref_paged_attention

__all__ = ["build_kernel", "paged_attention", "paged_decode_attention",
           "ref_paged_attention"]
