"""Sliding-window batching and overlap-averaged reconstruction.

Port of vistracker_tpu/ops/window_ops.py: a sequence becomes overlapping
windows, and windows go back to a sequence by averaging every window that
covers a frame (one index_add over static indices).
"""
from __future__ import annotations

import numpy as np
import torch


def _window_index(n: int, window: int, step: int) -> np.ndarray:
    return np.arange(n)[:, None] * step + np.arange(window)[None, :]


def seq_to_windows(x: torch.Tensor, window: int, step: int = 1) -> torch.Tensor:
    """(L, D) -> (N, window, D) overlapping windows, N = (L - window) //
    step + 1. L must be >= window (callers pad short sequences)."""
    n = (x.shape[0] - window) // step + 1
    idx = torch.as_tensor(_window_index(n, window, step), device=x.device)
    return x[idx]


def windows_to_seq(w: torch.Tensor, step: int,
                   out_len: int | None = None) -> torch.Tensor:
    """(N, window, D) -> (L, D), L = (N - 1) * step + window: the mean over
    all windows covering each frame."""
    n, window, d = w.shape
    L = (n - 1) * step + window
    idx = _window_index(n, window, step).reshape(-1)
    total = torch.zeros((L, d), dtype=w.dtype, device=w.device).index_add_(
        0, torch.as_tensor(idx, device=w.device), w.reshape(n * window, d))
    count = np.bincount(idx, minlength=L).astype(np.float32)
    out = total / torch.as_tensor(count, device=w.device)[:, None]
    return out if out_len is None else out[:out_len]


def pad_to_window(x: np.ndarray, window: int) -> tuple[np.ndarray, int]:
    """Repeat the last frame so len >= window; returns (padded, orig_len)."""
    L = x.shape[0]
    if L >= window:
        return x, L
    pad = np.repeat(x[-1:], window - L, axis=0)
    return np.concatenate([x, pad], axis=0), L
