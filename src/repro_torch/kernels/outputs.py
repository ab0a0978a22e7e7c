"""The kernels' output allocation: every wrapper allocates the buffer its
kernel writes through :func:`empty`, and nowhere else.

One hook (:func:`allocating_with`) can replace the allocator for a block:
``analysis.kernel_lint`` hands the wrappers buffers filled with a NaN
sentinel inside guard regions, launches them as the main path does and
checks that every output element was written and no guard element was
(launch coverage and bounds on the card).  The launch path is the same
with or without the hook; only where the buffer comes from differs.
Scratch buffers, which a kernel may leave partly unwritten, are not
outputs and are not allocated here.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

Tensor = torch.Tensor

_HOOK: Optional[Callable] = None


def empty(shape, dtype: torch.dtype, device) -> Tensor:
    """An uninitialised output buffer, or the installed hook's."""
    if _HOOK is not None:
        return _HOOK(tuple(shape), dtype, torch.device(device))
    return torch.empty(shape, dtype=dtype, device=device)


def empty_like(t: Tensor) -> Tensor:
    """:func:`empty` of ``t``'s shape, dtype and device."""
    return empty(t.shape, t.dtype, t.device)


@contextlib.contextmanager
def allocating_with(hook: Callable):
    """Allocate the kernels' outputs with ``hook(shape, dtype, device)``
    for the duration of a block."""
    global _HOOK
    prev, _HOOK = _HOOK, hook
    try:
        yield
    finally:
        _HOOK = prev
