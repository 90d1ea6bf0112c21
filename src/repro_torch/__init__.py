"""FastFabric on PyTorch and CUDA: the port of ``src/repro`` to an NVIDIA H100.

Same subpackage layout as the JAX package (``core/``, ``storage/``,
``kernels/<name>/``), plain functions on tensors, u32 words stored as int32
(see :mod:`repro_torch.core.u32`). Entry points take an explicit ``device``
and default to the card; see :func:`resolve_device`.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Raises when no card is present and none was named, so a run
    never drops to the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return torch.device("cuda")


def canonical_device(device) -> torch.device:
    """``device`` with its index filled in: a bare ``cuda`` names the
    current card, so that ``cuda`` and ``cuda:0`` compare equal there."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return dev
