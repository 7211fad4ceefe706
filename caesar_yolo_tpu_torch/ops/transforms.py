"""Preprocessing transforms: the README chain (zscale stretch, then
per-channel min-max normalisation).

Counterpart of caesar_yolo_tpu/ops/transforms.py for the stages on the
ported path.  A stage is a function on a tile batch
    fn(data[B, H, W, C] f32) -> (data', valid[B] bool)
with the reference's masking convention: pixels that are exactly 0 or
non-finite are left out of every statistic and come out as 0.

`build_preprocessor(zscale_stretch=True, normalize_minmax=True)` with
equal contrasts builds a Pipeline that runs the whole chain through the
fused kernel K3 (ops/cuda_preproc.py) on CUDA tensors.  The other
stages of the reference are not ported yet (ROADMAP.md, Queue 1 item 6).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from caesar_yolo_tpu_torch.ops.cuda_preproc import (
    fused_zscale_minmax,
    minmax_apply,
    valid_mask,
)
from caesar_yolo_tpu_torch.ops.zscale import zscale_apply, zscale_limits

Transform = Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


def _planes(data: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B*C, H, W] (one plane per tile channel)."""
    b, h, w, c = data.shape
    return data.permute(0, 3, 1, 2).reshape(b * c, h, w)


def _unplanes(planes: torch.Tensor, b: int) -> torch.Tensor:
    """[B*C, H, W] -> [B, H, W, C]."""
    p, h, w = planes.shape
    return planes.reshape(b, p // b, h, w).permute(0, 2, 3, 1)


def min_max_normalizer(norm_min: float = 0.0,
                       norm_max: float = 1.0) -> Transform:
    """Per-channel masked min-max normalisation; a tile is invalid when a
    channel has no valid pixel or a zero span."""

    def fn(data):
        out, lims = minmax_apply(_planes(data), norm_min, norm_max)
        ok = torch.isfinite(lims[:, 0]) & (lims[:, 1] != lims[:, 0])
        return _unplanes(out, data.shape[0]), ok.reshape(
            data.shape[0], -1).all(dim=1)

    return fn


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

    return fn


class Pipeline:
    """Stages applied in order to a tile batch.

    `fused` = (contrast, norm_min, norm_max) marks the README chain, which
    then runs as one call of `fused_zscale_minmax` (kernel K3 on CUDA)
    instead of stage by stage.  `channel_uniform` says every stage treats
    all channels alike, so a gray tile may be preprocessed once and
    repeated to 3 channels afterwards with the same result."""

    def __init__(self, stages: Sequence[Transform], fused=None,
                 channel_uniform: bool = False):
        self.stages = list(stages)
        self.fused = fused
        self.channel_uniform = channel_uniform

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
    subtract_bkg: bool = False,
    clip_shift_data: bool = False,
    clip_data: bool = False,
    nchannels: int = 1,
    zscale_stretch: bool = False, zscale_contrasts=(0.25, 0.25, 0.25),
    chan3_preproc: bool = False,
    normalize_minmax: bool = False, norm_min: float = 0.0,
    norm_max: float = 1.0,
) -> Pipeline | None:
    """Assemble the stage list as the reference does
    (caesar_yolo_tpu/ops/transforms.py:build_preprocessor) for the ported
    stages; None when no stage is enabled."""
    for flag, name in ((subtract_bkg, "subtract_bkg"),
                       (clip_shift_data, "clip_shift_data"),
                       (clip_data, "clip_data"),
                       (nchannels > 1, "nchannels > 1"),
                       (chan3_preproc, "chan3_preproc")):
        if flag:
            raise NotImplementedError(
                f"preprocessing stage {name} is not ported yet "
                f"(ROADMAP.md, Queue 1 item 6)")
    stages: list[Transform] = []
    if zscale_stretch:
        stages.append(zscale_transformer(contrasts=zscale_contrasts))
    if normalize_minmax:
        stages.append(min_max_normalizer(norm_min=norm_min,
                                         norm_max=norm_max))
    if not stages:
        return None
    uniform = (not zscale_stretch
               or len({float(c) for c in zscale_contrasts}) == 1)
    fused = None
    if zscale_stretch and normalize_minmax and uniform:
        fused = (float(zscale_contrasts[0]), float(norm_min),
                 float(norm_max))
    return Pipeline(stages, fused=fused, channel_uniform=uniform)
