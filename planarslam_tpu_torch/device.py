"""The device the port's public entry points run on.

Every public entry point (``System``, ``Tracking``, ``LocalMapping``,
``LoopClosing``, the BA, pose-graph, RANSAC and mapping-step wrappers)
defaults to ``"cuda"`` and resolves its argument here: asked for a card
where there is none, it raises instead of running on the CPU. A CPU run
names ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device for `device` (None means "cuda"); a CUDA device
    without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r}: CUDA is not available. "
            "planarslam_tpu_torch runs on an NVIDIA GPU; pass device='cpu' "
            "for a CPU run")
    return dev
