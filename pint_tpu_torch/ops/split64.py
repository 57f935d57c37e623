"""u64 words and their planar u32 pairs (port of ``split_u64``/``merge_u64``).

Counterpart of ``pint_tpu/ops/split64.py:248-260``.  A pair tensor is
*planar*: shape ``(2, ...)``, ``[0]`` the low half and ``[1]`` the high half
of each word, each u32 held in an int32 container.  The pair entries of
:mod:`pint_tpu_torch.ops.swar` take and return this form; 64-bit words
themselves live in int64 containers.

``SplitWord``/``SplitView`` (u64 arithmetic emulated on u32 halves) are not
ported: they exist because Mosaic has no 64-bit integer vectors, and Hopper
computes on ``uint64_t`` directly.
"""

from __future__ import annotations

import torch

__all__ = ["split_u64", "merge_u64"]


def split_u64(words: torch.Tensor) -> torch.Tensor:
    """int64 words ``(...)`` -> planar int32 pairs ``(2, ...)``."""
    if words.dtype != torch.int64:
        raise ValueError(f"split_u64 takes int64 words, got {words.dtype}")
    return torch.stack([words.to(torch.int32), (words >> 32).to(torch.int32)])


def merge_u64(pair: torch.Tensor) -> torch.Tensor:
    """Planar int32 pairs ``(2, ...)`` -> int64 words ``(...)``."""
    if pair.dim() < 1 or pair.shape[0] != 2 or pair.dtype != torch.int32:
        raise ValueError(
            "pair words must be planar int32 (2, ...) -- [0]=low half, "
            f"[1]=high half; got shape {tuple(pair.shape)} dtype {pair.dtype}"
        )
    return (pair[1].to(torch.int64) << 32) | (pair[0].to(torch.int64) & 0xFFFFFFFF)
