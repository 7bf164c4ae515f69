"""Neural surface-point generation by iterative UDF projection (stage 4).

Port of vistracker_tpu/fit/generator.py: samples start uniform in a box
around the body center, move p <- p - normalize(grad df) * df for a few
steps, survivors (df < 0.004, z > 1) are resampled with N(0, sigma)
noise for the next round, and a final top-k picks the surface points
whose pca / centers / visibility predictions are averaged. The funnel
harvest (FUNNEL_DEFAULT, the track default) pays one cheap df eval per
round and projects only the most promising candidates.

Randomness comes from a draw source passed to `generate`: `TorchDraws`
(a seeded CPU torch.Generator) by default; anything with the same three
methods can replay another generator's draws, which is how the tests
feed the JAX package's draws. The source is called in the JAX code's key
order: per target, uniform (box init), then per resampling round
categorical, normal, uniform (fresh restarts).
"""
from __future__ import annotations

import dataclasses
import time

import torch


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    num_steps: int = 10          # projection iterations per round
    num_rounds: int = 3          # fixed-budget rounds (scan harvest)
    samples_per_round: int = 20000
    num_points: int = 4000       # surface points kept per example
    df_clamp: float = 2.0
    filter_val: float = 0.004
    min_z: float = 1.0
    noise_sigma: float = 2.0 / 3.0
    box: tuple = (1.0, 1.5, 0.6)  # init box half-extents
    # per-round (n_candidates, n_keep, proj_steps); None -> scan harvest
    funnel: tuple | None = None
    center_agg: str = "mean"     # or "median" (robust opt-in)


# 20k explore -> project the best 12k; densify 12k from survivors ->
# project the best 8k
FUNNEL_DEFAULT = ((20000, 12000, 10), (12000, 8000, 8))


class TorchDraws:
    """Default draw source: a seeded CPU torch.Generator, so the same seed
    gives the same draws on any device; results move to `device`.
    `seconds` sums the host time of the draws, the device's queued work
    excluded: each draw waits for the stream anyway (the categorical reads
    the logits back, and a pageable host-to-device copy waits for it), so
    the clock starts after a synchronize."""

    def __init__(self, seed: int, device="cpu"):
        self.gen = torch.Generator().manual_seed(int(seed))
        self.device = torch.device(device)
        self.seconds = 0.0

    def _timed(self, draw):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = draw().to(self.device)
        self.seconds += time.perf_counter() - t0
        return out

    def uniform(self, shape) -> torch.Tensor:
        return self._timed(lambda: torch.rand(shape, generator=self.gen))

    def normal(self, shape) -> torch.Tensor:
        return self._timed(lambda: torch.randn(shape, generator=self.gen))

    def categorical(self, logits: torch.Tensor, n: int) -> torch.Tensor:
        """n indices per row of logits (B, N), with replacement."""
        return self._timed(lambda: torch.multinomial(
            torch.softmax(logits.detach().float().cpu(), -1), n,
            replacement=True, generator=self.gen))


def init_box_samples(u: torch.Tensor, body_center: torch.Tensor,
                     cfg: GeneratorConfig) -> torch.Tensor:
    """Uniform draws u (B, n, 3) in [0, 1) -> the body-centered box."""
    box = torch.tensor(cfg.box, dtype=u.dtype, device=u.device)
    return u * (box * 2.0) + (-box) + body_center[:, None, :]


def sifnet_query_fn(model):
    """SIFNet -> query_fn(cache, points, crop_center, body_center) giving
    the last stack's head dict; query_fn.df_only is the df-only head."""
    def query_fn(cache, points, crop_center, body_center):
        return model.query(cache, points, crop_center, body_center)[-1]

    query_fn.df_only = model.query_df
    return query_fn


def _top_idx(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row, ties to the lower
    index (a stable sort: the order jax.lax.top_k returns). Clamped df
    values tie often, so the order decides which points are kept."""
    return torch.sort(x, dim=1, descending=True, stable=True).indices[:, :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) gathered along N by idx (B, K)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def make_generator(query_fn, cfg: GeneratorConfig = GeneratorConfig()):
    """-> generate(cache, crop_center, body_center, draws) returning
    {"human": out, "object": out}, each with points (B, P, 3), valid
    (B, P), parts (B, P) int32, pca_axis (B, 3, 3), centers (B, 3),
    visibility (B, 1); P = cfg.num_points, means over valid points."""
    df_fast = getattr(query_fn, "df_only", None)

    def query_df(cache, pts, cc, bc, df_idx):
        preds = query_fn(cache, pts, cc, bc)
        return torch.clamp(preds["df"][..., df_idx], max=cfg.df_clamp), preds

    def df_cheap(cache, pts, cc, bc, df_idx):
        if df_fast is not None:
            return torch.clamp(df_fast(cache, pts, cc, bc)[..., df_idx],
                               max=cfg.df_clamp)
        return query_df(cache, pts, cc, bc, df_idx)[0]

    def project(cache, samples, cc, bc, df_idx, steps):
        with torch.enable_grad():
            for _ in range(steps):
                pts = samples.detach().requires_grad_(True)
                df = df_cheap(cache, pts, cc, bc, df_idx)
                (grad,) = torch.autograd.grad(df.sum(), pts)
                g = grad / torch.clamp(
                    torch.linalg.norm(grad, dim=-1, keepdim=True), min=1e-12)
                samples = (pts - g * df[..., None]).detach()
        return samples

    def harvest(cache, samples, cc, bc, df_idx, steps):
        """Project, then query all heads at the surface points."""
        surf = project(cache, samples, cc, bc, df_idx, steps)
        with torch.no_grad():
            df, preds = query_df(cache, surf, cc, bc, df_idx)
        valid = (df < cfg.filter_val) & (surf[..., 2] > cfg.min_z)
        return dict(points=surf, valid=valid, df=df, parts=preds["parts"],
                    pca=preds["pca"], centers=preds["centers"],
                    vis=preds["vis"])

    def resample(out, bc, n, draws):
        """Next round's starts: survivors + noise, or fresh box samples
        for examples with no survivor."""
        valid, surf = out["valid"], out["points"]
        logits = torch.where(valid, 0.0, -1e9)
        any_valid = valid.any(-1, keepdim=True)
        picked = _take(surf, draws.categorical(logits, n))
        picked = picked + cfg.noise_sigma * draws.normal(picked.shape)
        fresh = init_box_samples(draws.uniform((surf.shape[0], n, 3)), bc,
                                 cfg)
        return torch.where(any_valid[..., None], picked, fresh)

    def finalize(pool: dict, B: int) -> dict:
        """Top-k over the harvested pool (valid first, then smallest df)
        and masked aggregation over the selected valid points."""
        valid, df = pool["valid"], pool["df"]
        score = torch.where(valid, -df, -1e9 - df)
        top = _top_idx(score, cfg.num_points)
        sel_valid = _take(valid, top)
        vmask = sel_valid.float()
        denom = torch.clamp(vmask.sum(1), min=1.0)

        def masked_mean(x):
            m = vmask.reshape(vmask.shape + (1,) * (x.dim() - 2))
            return (x * m).sum(1) / denom.reshape((B,) + (1,) * (x.dim() - 2))

        def masked_median(x):
            m = vmask.reshape(vmask.shape + (1,) * (x.dim() - 2)) > 0
            med = torch.nanquantile(torch.where(m, x, torch.nan), 0.5, dim=1)
            return torch.nan_to_num(med, nan=0.0)

        agg = masked_median if cfg.center_agg == "median" else masked_mean
        return dict(
            points=_take(pool["points"], top), valid=sel_valid,
            parts=torch.argmax(_take(pool["parts"], top), -1).to(torch.int32),
            pca_axis=agg(_take(pool["pca"], top)),
            centers=agg(_take(pool["centers"], top)),
            visibility=masked_mean(_take(pool["vis"], top)))

    def target_funnel(cache, cc, bc, draws, df_idx):
        B = cc.shape[0]
        samples = init_box_samples(
            draws.uniform((B, cfg.funnel[0][0], 3)), bc, cfg)
        pools = []
        for r, (n_cand, n_keep, steps) in enumerate(cfg.funnel):
            if n_keep < n_cand:
                with torch.no_grad():
                    df0 = df_cheap(cache, samples, cc, bc, df_idx)
                samples = _take(samples, _top_idx(-df0, n_keep))
            pools.append(harvest(cache, samples, cc, bc, df_idx, steps))
            if r + 1 < len(cfg.funnel):
                samples = resample(pools[-1], bc, cfg.funnel[r + 1][0], draws)
        pool = {k: torch.cat([p[k] for p in pools], 1) for k in pools[0]}
        return finalize(pool, B)

    def target_scan(cache, cc, bc, draws, df_idx):
        B, n = cc.shape[0], cfg.samples_per_round
        samples = init_box_samples(draws.uniform((B, n, 3)), bc, cfg)
        pools = []
        for _ in range(cfg.num_rounds):
            pools.append(harvest(cache, samples, cc, bc, df_idx,
                                 cfg.num_steps))
            samples = resample(pools[-1], bc, n, draws)
        pool = {k: torch.cat([p[k] for p in pools], 1) for k in pools[0]}
        return finalize(pool, B)

    target = target_funnel if cfg.funnel is not None else target_scan

    def generate(cache, crop_center, body_center, draws):
        return {name: target(cache, crop_center, body_center, draws, i)
                for i, name in enumerate(("human", "object"))}

    return generate
