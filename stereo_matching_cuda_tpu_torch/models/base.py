"""Common interface for stereo matchers."""

from __future__ import annotations

import abc

import numpy as np
import torch
from torch import nn

from ..config import StereoConfig, DEFAULT_CONFIG


class StereoMatcher(nn.Module, abc.ABC):
    """A stereo matcher: uint8 RGB pair in, disparity maps out, on
    ``device`` (the card unless the caller asks for the CPU).

    ``forward(left, right)`` takes uint8 (H,W,C) tensors, moves them to
    the matcher's device and returns the dict of tensors there;
    ``compute`` is the numpy convenience.  The matchers hold no weights:
    the config is their whole state."""

    def __init__(self, cfg: StereoConfig = DEFAULT_CONFIG,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> dict:
        return self._forward(left.to(self.device), right.to(self.device))

    @abc.abstractmethod
    def _forward(self, left: torch.Tensor, right: torch.Tensor) -> dict:
        ...

    @torch.no_grad()
    def compute(self, left: np.ndarray, right: np.ndarray) -> dict:
        out = self(torch.from_numpy(np.ascontiguousarray(left)),
                   torch.from_numpy(np.ascontiguousarray(right)))
        return {k: v.cpu().numpy() for k, v in out.items()}
