"""The yardstick's counts against hand counts at small shapes."""
from __future__ import annotations

import itertools

import pytest
import torch

from portbench import counters
from portbench.reference import sifnet as RS
from portbench.tests import cells

TINY = cells.tiny("train.b8")[1]["sifnet"]


def _block(cin, cout, hw):
    """A ConvBlock's multiply-adds at hw pixels: three 3x3 convs (half,
    quarter, quarter of cout) and, where cin != cout, a 1x1 downsample."""
    half, quarter = cout // 2, cout // 4
    macs = hw * 9 * (cin * half + half * quarter + quarter * quarter)
    return macs + (hw * cin * cout if cin != cout else 0)


def _filter(cin, stacks, depth, dim, tmpx, size):
    """An hourglass filter's multiply-adds, layer by layer."""
    hf = counters.RS.HG_FEATURES
    h2, h4 = (size // 2) ** 2, (size // 4) ** 2
    macs = h2 * tmpx * cin * 49 + _block(tmpx, 128, h2)
    macs += _block(128, 128, h4) + _block(128, hf, h4)
    for i in range(stacks):
        for level in range(depth, 0, -1):
            here = h4 // 4 ** (depth - level)
            macs += _block(hf, hf, here) + 2 * _block(hf, hf, here // 4)
            if level == 1:
                macs += _block(hf, hf, here // 4)
        macs += _block(hf, hf, h4) + h4 * hf * hf + h4 * hf * dim
        if i < stacks - 1:
            macs += h4 * hf * hf + h4 * dim * hf
    return macs


@pytest.mark.parametrize("size", [16, 32])
def test_encode_flops_by_hand(size):
    c = TINY
    hand = (_filter(5, c["num_stack"], c["num_hourglass"],
                    c["hourglass_dim"], c["tmpx_dim"], size)
            + 3 * _filter(1, c["triplane_stack"], c["num_hourglass"],
                          c["triplane_hg_dim"], c["triplane_tmpx_dim"],
                          size))
    assert counters.encode_flops(c, size) == 2 * hand
    assert counters.encode_flops(c, size, frames=3) == 6 * hand


def test_head_and_step_flops_by_hand():
    c = TINY
    fs = 32 + 3 + 32 + 3 * (32 + 32)
    assert RS.feature_size(c) == fs
    assert counters.head_flops(c, "parts") == 2 * (fs * 16 + 2 * 16 * 16
                                                   + 16 * 14)
    heads = sum(counters.head_flops(c, h) for h in RS.HEADS)
    assert counters.train_step_flops(c, 2, 100, 32) == 3 * (
        counters.encode_flops(c, 32, 2, train=True) + 2 * 100 * heads)


def test_bound():
    b = counters.bound(67e9, 1.0)
    assert b["bound_by"] == "operations" and b["bound_ms"] == pytest.approx(1)
    b = counters.bound(1.0, 3.35e9)
    assert b["bound_by"] == "bytes" and b["bound_ms"] == pytest.approx(1)
    k1 = counters.k1_need(10, 2, 0)
    assert k1["bound_ms"] == pytest.approx(
        (10 * 55 + 2 * (8 * 10 + 8 * 16 * 15)) / 67e12 * 1e3)


def test_compatible_pairs_brute_force():
    g = torch.Generator().manual_seed(0)
    lx = torch.randint(0, 5, (3, 40), generator=g)
    ly = torch.randint(0, 5, (3, 30), generator=g)
    valid = torch.rand(3, 30, generator=g) < 0.6
    brute = sum(int(lx[b, i] == ly[b, j] and valid[b, j])
                for b, i, j in itertools.product(range(3), range(40),
                                                 range(30)))
    assert counters.compatible_pairs(lx, ly, valid) == brute


def test_k2_walk_share_counts_live_triples():
    """Every (face, row, chunk) triple of a live cell is tested; with m
    at its lowest every test keeps it; with no live cell none is."""
    size, Fp = 32, 128
    cpl = torch.randn(1, Fp, 15)
    active = torch.ones(size // 8, Fp // 128, dtype=torch.int32)
    low = torch.full((1, size, size), -1e9)
    out = counters.k2_walk_share(cpl, active, low, size)
    assert out["triples"] == Fp * size * 2 == out["walked"]
    none = counters.k2_walk_share(cpl, torch.zeros_like(active), low, size)
    assert none["triples"] == 0 == none["walked"]
