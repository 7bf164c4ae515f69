"""Seeded random weights, made on the run's device in one draw.

Every tensor of at least two dimensions, and the bias beside such a
weight, is uniform in +-1/sqrt(fan_in) (PyTorch's default bound, fan_in
the product of the weight's trailing dimensions); a one-dimensional
weight (a norm's scale) is 1 and its bias 0. One torch.rand call on a
generator of the device draws every uniform, so the weights depend on
the seed, the order of the names and their shapes only.
"""
from __future__ import annotations

import math

import torch


def _fan_in(name: str, shapes: dict) -> int:
    """The fan-in a tensor is drawn with; 0 for a constant (a norm)."""
    shape = shapes[name]
    if len(shape) >= 2:
        return math.prod(shape[1:])
    if name.endswith("bias"):
        sibling = shapes.get(name[:-len("bias")] + "weight")
        if sibling is not None and len(sibling) >= 2:
            return math.prod(sibling[1:])
    return 0


def make(spec: list, seed: int, device) -> dict:
    """spec [(name, shape)] -> {name: float32 tensor on device}."""
    shapes = {n: tuple(s) for n, s in spec}
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    drawn = [n for n, _ in spec if _fan_in(n, shapes)]
    total = sum(math.prod(shapes[n]) for n in drawn)
    u = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in spec:
        fan = _fan_in(name, shapes)
        if fan:
            k = math.prod(shape)
            bound = 1.0 / math.sqrt(fan)
            out[name] = (u[at:at + k] * (2 * bound) - bound).reshape(shape)
            at += k
        elif name.endswith("bias"):
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.ones(shape, device=device)
    return out


def fill_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Draw every parameter of `module` (already on its device) by
    make(), in named_parameters() order."""
    params = dict(module.named_parameters())
    device = next(iter(params.values())).device
    drawn = make([(n, tuple(p.shape)) for n, p in params.items()], seed,
                 device)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(drawn[n])
    return module


def net_seed(seed: int, salt: int) -> int:
    """The seed of one network of a run: the run's seed and the net's
    salt, mixed so that nets of one run differ."""
    return (seed * 1_000_003 + salt * 7_919) % 2 ** 63
