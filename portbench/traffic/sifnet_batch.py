"""Seeded SIF-Net training batches: the input of the `train` cells.

FROZEN COPY of chip_smoke.py's sifnet_batch at commit ebfc849 (the same
distributions), drawn with a torch.Generator on the run's device instead
of numpy on the host. A change that claims a speed-up may not edit this
file.

A batch: images (B, S, S, 8) uniform in [0, 1); body centres around
(0, 0, 2.2) m (sd 5 cm) and their crop centres, the Kinect projection of
the body centre; N query points around each body centre (sd 15 cm, most
inside the crop); GT distances df_h, df_o uniform in [0, 0.15) m; part
labels uniform over the parts; PCA axes, object centres standard normal;
visibilities uniform.
"""
from __future__ import annotations

import torch

# Kinect Azure colour camera in pixels of the 2048-wide frame
FX, FY = 979.7844, 979.840
CX, CY = 1018.952, 779.486


def sifnet_batch(gen: torch.Generator, B: int, N: int, S: int, parts: int,
                 device) -> dict:
    kw = dict(generator=gen, device=device)
    bc = torch.tensor([0.0, 0.0, 2.2], device=device) \
        + torch.randn(B, 3, **kw) * 0.05
    cc = torch.stack([FX * bc[:, 0] / bc[:, 2] + CX,
                      FY * bc[:, 1] / bc[:, 2] + CY], -1)
    return dict(
        images=torch.rand(B, S, S, 8, **kw),
        points=bc[:, None] + torch.randn(B, N, 3, **kw) * 0.15,
        crop_center=cc, body_center=bc,
        df_h=torch.rand(B, N, **kw) * 0.15,
        df_o=torch.rand(B, N, **kw) * 0.15,
        parts=torch.randint(0, parts, (B, N), **kw),
        pca=torch.randn(B, N, 3, 3, **kw),
        obj_center=torch.randn(B, 3, **kw),
        visibility=torch.rand(B, N, **kw))
