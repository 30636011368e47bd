"""Shading math (the port of `tracer/core/mathutils.py`); only what the
forward slice uses."""

from __future__ import annotations

import torch


def gamma_correct(color):
    """Per-channel 1/2.2 gamma (reference: Functions.cpp:56-60)."""
    return torch.pow(torch.clamp_min(color, 0.0), 1.0 / 2.2)
