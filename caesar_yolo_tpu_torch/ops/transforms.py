"""Preprocessing transforms: the stages `build_preprocessor` can build.

Counterpart of caesar_yolo_tpu/ops/transforms.py for the stages a CLI
flag reaches: background subtraction, sigma clip-shift, sigma clip,
channel resize, zscale stretch, the chan3 composite and per-channel
min-max normalisation.  A stage is a function on a tile batch
    fn(data[B, H, W, C] f32) -> (data', valid[B] bool)
with the reference's masking convention: pixels that are exactly 0 or
non-finite are left out of every statistic and come out as 0.  Each
stage follows the reference's batch path (its `.batch` function where it
has one): the sigma-clip statistics run through kernel K5
(ops/cuda_stats.py) and the histogram equalisation through kernel K6
(ops/cuda_histeq.py) on CUDA tensors.

`build_preprocessor(zscale_stretch=True, normalize_minmax=True)` with
equal contrasts builds a Pipeline that runs the whole chain through the
fused kernel K3 (ops/cuda_preproc.py) on CUDA tensors.  The factories no
flag reaches (the scalers, shifters, stretches, resizer, divider and
hist_equalizer) are not ported yet (ROADMAP.md, Queue 1 item 6).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from caesar_yolo_tpu_torch.ops.cuda_histeq import equalize_hist_batch
from caesar_yolo_tpu_torch.ops.cuda_preproc import (
    fused_zscale_minmax,
    minmax_apply,
)
from caesar_yolo_tpu_torch.ops.cuda_stats import clip_stats
from caesar_yolo_tpu_torch.ops.stats import valid_mask
from caesar_yolo_tpu_torch.ops.zscale import zscale_apply, zscale_limits

Transform = Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


def center_box_slices(h: int, w: int, fract: float):
    """Centre-box bounds of the mask-box options (reference
    preprocessing.py:204-215)."""
    xc, yc = int(w / 2), int(h / 2)
    dy, dx = int(h * fract / 2.0), int(w * fract / 2.0)
    return yc - dy, yc + dy, xc - dx, xc + dx


def _planes(data: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B*C, H, W] (one plane per tile channel)."""
    b, h, w, c = data.shape
    return data.permute(0, 3, 1, 2).reshape(b * c, h, w)


def _unplanes(planes: torch.Tensor, b: int) -> torch.Tensor:
    """[B*C, H, W] -> [B, H, W, C]."""
    p, h, w = planes.shape
    return planes.reshape(b, p // b, h, w).permute(0, 2, 3, 1)


def _stage(fn, uniform: bool, reshapes: bool = False):
    """Mark a stage: `uniform` when it treats every channel alike (so a
    gray tile may run it on one plane instead of on repeated copies),
    `reshapes` when it changes the channel count (repeating a gray tile's
    plane gives what it gives on repeated copies)."""
    fn.uniform = uniform
    fn.reshapes = reshapes
    return fn


def _per_channel(data: torch.Tensor, chid: int, fn):
    """Apply fn(planes[B*k, H, W]) -> (planes', valid[B*k]) to the channels
    chid selects (-1: all) of data [B, H, W, C] in one call; the others
    pass through as valid."""
    b, c = data.shape[0], data.shape[-1]
    chans = [i for i in range(c) if chid in (-1, i)]
    valid = torch.ones(b, dtype=torch.bool, device=data.device)
    if not chans:
        return data, valid
    sel = data[..., chans]
    out, ok = fn(_planes(sel))
    valid = valid & ok.reshape(b, -1).all(dim=1)
    if len(chans) == c:
        return _unplanes(out, b), valid
    data = data.clone()
    data[..., chans] = _unplanes(out, b)
    return data, valid


def min_max_normalizer(norm_min: float = 0.0,
                       norm_max: float = 1.0) -> Transform:
    """Per-channel masked min-max normalisation; a tile is invalid when a
    channel has no valid pixel or a zero span."""

    def fn(data):
        out, lims = minmax_apply(_planes(data), norm_min, norm_max)
        ok = torch.isfinite(lims[:, 0]) & (lims[:, 1] != lims[:, 0])
        return _unplanes(out, data.shape[0]), ok.reshape(
            data.shape[0], -1).all(dim=1)

    return _stage(fn, uniform=True)


def bkg_subtractor(sigma: float = 3.0, use_mask_box: bool = False,
                   mask_fract: float = 0.7, chid: int = -1) -> Transform:
    """Subtract each channel's sigma-clipped mean background (reference
    preprocessing.py:591-658; transforms.py:bkg_subtractor.batch).  With
    use_mask_box, the centre box is left out of the estimate (source
    region).  Invalid when a channel has no valid pixel."""

    def planes_fn(x):
        bkgdata = x
        if use_mask_box:
            h, w = x.shape[1:]
            y0, y1, x0, x1 = center_box_slices(h, w, mask_fract)
            bkgdata = x.clone()
            bkgdata[:, y0:y1, x0:x1] = 0.0
        stats, counts = clip_stats(bkgdata, sigma, sigma)
        out = torch.where(valid_mask(x), x - stats[:, 0, None, None], 0.0)
        return out, counts[:, 0] > 0

    return _stage(lambda data: _per_channel(data, chid, planes_fn),
                  uniform=chid == -1)


def sigma_clip_shifter(sigma: float = 1.0, chid: int = -1) -> Transform:
    """Galvin+2019 clip-shift: subtract clipped_mean + sigma * std and
    clip below 0 (reference preprocessing.py:664-717)."""

    def planes_fn(x):
        stats, counts = clip_stats(x, sigma, sigma)
        newzero = (stats[:, 0] + sigma * stats[:, 2])[:, None, None]
        out = x - newzero
        out = torch.where(out < 0, 0.0, out)
        return torch.where(valid_mask(x), out, 0.0), counts[:, 0] > 0

    return _stage(lambda data: _per_channel(data, chid, planes_fn),
                  uniform=chid == -1)


def sigma_clipper(sigma_low: float = 10.0, sigma_up: float = 10.0,
                  chid: int = -1) -> Transform:
    """Clamp pixels to the final sigma-clip bounds (reference
    preprocessing.py:723-771)."""

    def planes_fn(x):
        stats, counts = clip_stats(x, sigma_low, sigma_up)
        # jnp.clip(x, lower, upper) = min(max(x, lower), upper)
        out = torch.minimum(torch.maximum(x, stats[:, 3, None, None]),
                            stats[:, 4, None, None])
        return torch.where(valid_mask(x), out, 0.0), counts[:, 0] > 0

    return _stage(lambda data: _per_channel(data, chid, planes_fn),
                  uniform=chid == -1)


def chan_resizer(nchans: int) -> Transform:
    """Repeat the last channel up to nchans, or truncate down (reference
    preprocessing.py:1077-1133)."""
    if not 0 < nchans <= 1000:
        raise ValueError(f"invalid channel count {nchans}")

    def fn(data):
        cur = data.shape[-1]
        ok = torch.ones(data.shape[0], dtype=torch.bool, device=data.device)
        if nchans > cur:
            extra = data[..., cur - 1:cur].expand(-1, -1, -1, nchans - cur)
            return torch.cat([data, extra], dim=-1), ok
        return data[..., :nchans], ok

    return _stage(fn, uniform=True, reshapes=True)


def zscale_transformer(contrasts: Sequence[float] = (0.25, 0.25, 0.25)
                       ) -> Transform:
    """Per-channel zscale stretch (limits from each tile's own channel,
    zeros included in the sampling); masked pixels are restored to 0."""

    def fn(data):
        c = data.shape[-1]
        if len(contrasts) < c:
            raise ValueError(f"Invalid contrasts given (size="
                             f"{len(contrasts)} < nchans={c})")
        chans = []
        for i in range(c):
            x = data[..., i]
            vmin, vmax = zscale_limits(x, contrast=float(contrasts[i]))
            z = zscale_apply(x, vmin[:, None, None], vmax[:, None, None])
            chans.append(torch.where(valid_mask(x), z, 0.0))
        return (torch.stack(chans, dim=-1),
                torch.ones(data.shape[0], dtype=torch.bool,
                           device=data.device))

    return _stage(fn, uniform=len({float(c) for c in contrasts}) == 1)


def chan3_transformer(sigma_clip_baseline: float = 0.0,
                      sigma_clip_low: float = 1.0,
                      sigma_clip_up: float = 20.0,
                      zscale_contrast: float = 0.25) -> Transform:
    """3-channel composite (reference preprocessing.py:1020-1072, the
    batch path transforms.py:621-641):
      ch1 = zscale(sigmaclip(baseline, up)), ch2 = zscale(sigmaclip(low,
      up)), ch3 = histeq(raw), masked pixels 0."""
    clip1 = sigma_clipper(sigma_clip_baseline, sigma_clip_up)
    clip2 = sigma_clipper(sigma_clip_low, sigma_clip_up)
    zs = zscale_transformer([zscale_contrast])

    def fn(data):
        cur = data.shape[-1]
        if cur < 3:
            extra = data[..., cur - 1:cur].expand(-1, -1, -1, 3 - cur)
            cube = torch.cat([data, extra], dim=-1)
        else:
            cube = data[..., :3]

        def one(chan, clip_stage):
            x, va = clip_stage(chan[..., None])
            x, vb = zs(x)
            return x[..., 0], va & vb

        c1, v1 = one(cube[..., 0], clip1)
        c2, v2 = one(cube[..., 1], clip2)
        raw3 = cube[..., 2]
        c3 = torch.where(valid_mask(raw3), equalize_hist_batch(raw3), 0.0)
        return torch.stack([c1, c2, c3], dim=-1), v1 & v2

    return _stage(fn, uniform=True, reshapes=True)


def _gray_equivalent(stages: Sequence[Transform]) -> bool:
    """Whether the stages give a gray tile's result on its one plane as
    on its plane repeated: every stage up to the first that changes the
    channel count treats all channels alike."""
    for stage in stages:
        if not stage.uniform:
            return False
        if stage.reshapes:
            return True
    return True


class Pipeline:
    """Stages applied in order to a tile batch.

    `fused` = (contrast, norm_min, norm_max) marks the README chain, which
    then runs as one call of `fused_zscale_minmax` (kernel K3 on CUDA)
    instead of stage by stage.  `channel_uniform` says a gray tile may be
    preprocessed on its one plane and repeated to 3 channels afterwards
    (where a stage has not done so already) with the same result."""

    def __init__(self, stages: Sequence[Transform], fused=None):
        self.stages = list(stages)
        self.fused = fused
        self.channel_uniform = _gray_equivalent(self.stages)

    def apply_batch(self, tiles: torch.Tensor):
        """[B, H, W, C] -> (out f32 [B, H, W, C], valid[B])."""
        data = tiles.float()
        b = data.shape[0]
        if self.fused is not None:
            contrast, norm_min, norm_max = self.fused
            out, ok = fused_zscale_minmax(_planes(data), contrast=contrast,
                                          norm_min=norm_min,
                                          norm_max=norm_max)
            return _unplanes(out, b), ok.reshape(b, -1).all(dim=1)
        valid = torch.ones(b, dtype=torch.bool, device=data.device)
        for stage in self.stages:
            data, v = stage(data)
            valid = valid & v
        return data, valid


def prepare_tiles(tiles: torch.Tensor, preprocessor: Pipeline | None,
                  nchan: int):
    """Tiles [B, H, W, C] -> (model-ready images f32 [B, H, W, nchan],
    tile_ok[B]), as the reference's engine (engine.py:55-73): gray tiles
    repeat to `nchan` channels before preprocessing (after it, when the
    pipeline treats channels alike -- the same values for 1/nchan of the
    work), then the degenerate-channel guard marks a tile whose channel
    is constant (min == max) as not ok."""
    x = tiles.float()
    gray = x.shape[-1] == 1 and nchan > 1
    if gray and preprocessor is not None and not preprocessor.channel_uniform:
        x = x.expand(-1, -1, -1, nchan)
    if preprocessor is not None:
        imgs, ok = preprocessor.apply_batch(x)
    else:
        imgs = x
        ok = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    if imgs.shape[-1] == 1 and nchan > 1:
        imgs = imgs.expand(-1, -1, -1, nchan)
    cmin = imgs.amin(dim=(1, 2))
    cmax = imgs.amax(dim=(1, 2))
    return imgs, ok & (cmax > cmin).all(dim=-1)


def build_preprocessor(
    *,
    subtract_bkg: bool = False, sigma_bkg: float = 3.0,
    use_box_mask_in_bkg: bool = False, bkg_box_mask_fract: float = 0.7,
    bkg_chid: int = -1,
    clip_shift_data: bool = False, sigma_clip: float = 1.0,
    clip_data: bool = False, sigma_clip_low: float = 10.0,
    sigma_clip_up: float = 10.0, clip_chid: int = -1,
    nchannels: int = 1,
    zscale_stretch: bool = False, zscale_contrasts=(0.25, 0.25, 0.25),
    chan3_preproc: bool = False, sigma_clip_baseline: float = 0.0,
    normalize_minmax: bool = False, norm_min: float = 0.0,
    norm_max: float = 1.0,
) -> Pipeline | None:
    """Assemble the stage list exactly as the reference does
    (caesar_yolo_tpu/ops/transforms.py:build_preprocessor, reference
    scripts/run.py:272-302); None when no stage is enabled."""
    stages: list[Transform] = []
    if subtract_bkg:
        stages.append(bkg_subtractor(
            sigma=sigma_bkg, use_mask_box=use_box_mask_in_bkg,
            mask_fract=bkg_box_mask_fract, chid=bkg_chid))
    if clip_shift_data:
        stages.append(sigma_clip_shifter(sigma=sigma_clip, chid=clip_chid))
    if clip_data:
        stages.append(sigma_clipper(
            sigma_low=sigma_clip_low, sigma_up=sigma_clip_up, chid=clip_chid))
    if nchannels > 1:
        stages.append(chan_resizer(nchans=nchannels))
    if zscale_stretch:
        stages.append(zscale_transformer(contrasts=zscale_contrasts))
    if chan3_preproc:
        stages.append(chan3_transformer(
            sigma_clip_baseline=sigma_clip_baseline,
            sigma_clip_low=sigma_clip_low, sigma_clip_up=sigma_clip_up,
            zscale_contrast=float(zscale_contrasts[0])))
    if normalize_minmax:
        stages.append(min_max_normalizer(norm_min=norm_min,
                                         norm_max=norm_max))
    if not stages:
        return None
    fused = None
    if (zscale_stretch and normalize_minmax and not subtract_bkg
            and not clip_shift_data and not clip_data and nchannels <= 1
            and not chan3_preproc
            and len({float(c) for c in zscale_contrasts}) == 1):
        # the README chain (reference test/run_inference.sh): fused kernel
        fused = (float(zscale_contrasts[0]), float(norm_min),
                 float(norm_max))
    return Pipeline(stages, fused=fused)
