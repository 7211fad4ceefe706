"""Preprocessing transforms: every stage of the reference's transform set.

Counterpart of caesar_yolo_tpu/ops/transforms.py.  A stage is a function
on a tile batch
    fn(data[B, H, W, C] f32) -> (data', valid[B] bool)
with the reference's masking convention: pixels that are exactly 0 or
non-finite are left out of every statistic and come out as 0 (with the
reference's exception in log_stretcher, see there).  Each stage follows
the reference's batch path (its `.batch` function where it has one, else
its per-image function over the batch): the sigma-clip statistics run
through kernel K5 (ops/cuda_stats.py), histogram equalisation through
kernel K6 (ops/cuda_histeq.py) and its adaptive form (CLAHE) through
kernel K7 (ops/cuda_clahe.py) on CUDA tensors.

`build_preprocessor(zscale_stretch=True, normalize_minmax=True)` with
equal contrasts builds a Pipeline that runs the whole chain through the
fused kernel K3 (ops/cuda_preproc.py) on CUDA tensors.  Stages no CLI
flag reaches (the scalers, shifters, stretches, border mask, resizer,
channel divider and hist_equalizer) are built by calling their factories
and composing a Pipeline, as with the reference's class API.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from caesar_yolo_tpu_torch.ops.cuda_clahe import equalize_adapthist_batch
from caesar_yolo_tpu_torch.ops.cuda_histeq import equalize_hist_batch
from caesar_yolo_tpu_torch.ops.cuda_preproc import (
    fused_zscale_minmax,
    minmax_apply,
)
from caesar_yolo_tpu_torch.ops.cuda_stats import clip_stats
from caesar_yolo_tpu_torch.ops.stats import masked_max, masked_min, valid_mask
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


def _ones(data: torch.Tensor) -> torch.Tensor:
    return torch.ones(data.shape[0], dtype=torch.bool, device=data.device)


def _center_box(h: int, w: int, fract: float, device) -> torch.Tensor:
    """[H, W] bool: the centre box of the mask-box options."""
    y0, y1, x0, x1 = center_box_slices(h, w, fract)
    box = torch.zeros((h, w), dtype=torch.bool, device=device)
    box[y0:y1, x0:x1] = True
    return box


def _runs(chans: list[int]) -> list[tuple[int, int]]:
    """Ascending channel indices -> their runs of consecutive channels as
    slice bounds [(start, stop)]."""
    runs: list[tuple[int, int]] = []
    for i in chans:
        if runs and runs[-1][1] == i:
            runs[-1] = (runs[-1][0], i + 1)
        else:
            runs.append((i, i + 1))
    return runs


def _per_channel(data: torch.Tensor, chid: int, fn, skip: bool = False):
    """Apply fn(planes[B*k, H, W]) -> (planes', valid[B*k]) to the channels
    chid selects (-1: all; with skip=True every channel but chid) of data
    [B, H, W, C] in one call; the others pass through as valid.  The
    channels are taken and put back by slices: a list index would copy
    itself to the device first, a host wait that no CUDA graph can
    capture."""
    b, c = data.shape[0], data.shape[-1]
    runs = _runs([i for i in range(c)
                  if chid == -1 or (i != chid if skip else i == chid)])
    valid = _ones(data)
    if not runs:
        return data, valid
    parts = [data[..., a:e] for a, e in runs]
    sel = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    out, ok = fn(_planes(sel))
    valid = valid & ok.reshape(b, -1).all(dim=1)
    out = _unplanes(out, b)
    if runs == [(0, c)]:
        return out, valid
    data = data.clone()
    k = 0
    for a, e in runs:
        data[..., a:e] = out[..., k:k + e - a]
        k += e - a
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


def abs_min_max_normalizer(norm_min: float = 0.0,
                           norm_max: float = 1.0) -> Transform:
    """Min-max normalisation over all channels together (reference
    preprocessing.py:116-145)."""

    def fn(data):
        cond = valid_mask(data)
        lo = masked_min(data, cond, dim=(1, 2, 3))[:, None, None, None]
        hi = masked_max(data, cond, dim=(1, 2, 3))[:, None, None, None]
        span = hi - lo
        out = ((data - lo) / torch.where(span != 0, span, 1.0)
               * (norm_max - norm_min) + norm_min)
        return (torch.where(cond, out, 0.0),
                (cond.sum(dim=(1, 2, 3)) > 0) & (span.flatten() != 0))

    return _stage(fn, uniform=False)


def max_scaler() -> Transform:
    """Divide each channel by its own masked max (reference
    preprocessing.py:152-176)."""

    def fn(data):
        cond = valid_mask(data)
        mx = masked_max(data, cond, dim=(1, 2))[:, None, None, :]
        out = data / torch.where(mx != 0, mx, 1.0)
        return (torch.where(cond, out, 0.0),
                (cond.sum(dim=(1, 2)) > 0).all(dim=-1))

    return _stage(fn, uniform=True)


def abs_max_scaler(use_mask_box: bool = False,
                   mask_fract: float = 0.5) -> Transform:
    """Divide by the masked max over all channels, optionally within the
    centre box (reference preprocessing.py:182-226)."""

    def fn(data):
        cond = valid_mask(data)
        cond_max = cond
        if use_mask_box:
            box = _center_box(*data.shape[1:3], mask_fract, data.device)
            cond_max = cond & box[None, :, :, None]
        mx = masked_max(data, cond_max, dim=(1, 2, 3))[:, None, None, None]
        out = data / torch.where(mx != 0, mx, 1.0)
        return torch.where(cond, out, 0.0), cond_max.sum(dim=(1, 2, 3)) > 0

    return _stage(fn, uniform=False)


def chan_max_scaler(chref: int = 0, use_mask_box: bool = False,
                    mask_fract: float = 0.5) -> Transform:
    """Divide every channel by the reference channel's masked max
    (reference preprocessing.py:232-289); invalid when any channel's max is
    not positive and finite."""

    def fn(data):
        region = data
        if use_mask_box:
            y0, y1, x0, x1 = center_box_slices(*data.shape[1:3], mask_fract)
            region = data[:, y0:y1, x0:x1, :]
        cond_region = valid_mask(region)
        ref = region[..., chref]
        cond_ref = cond_region[..., chref]
        mx = masked_max(ref, cond_ref, dim=(1, 2))
        ch_max = masked_max(region, cond_region, dim=(1, 2))
        valid = ((cond_ref.sum(dim=(1, 2)) > 0)
                 & ((ch_max > 0) & torch.isfinite(ch_max)).all(dim=-1))
        out = data / torch.where(mx != 0, mx, 1.0)[:, None, None, None]
        return torch.where(valid_mask(data), out, 0.0), valid

    return _stage(fn, uniform=False)


def _channel_values(values: Sequence[float]):
    """The per-channel constants of scaler/shifter/standardizer and whether
    they treat every channel alike."""
    values = [float(v) for v in values]
    return values, len(set(values)) == 1


def _channel_tensor(values, uniform: bool, data: torch.Tensor, name: str):
    """values as a [C] tensor for data's C channels: a gray tile taking
    the one-plane route of a channel-uniform chain takes the one value."""
    c = data.shape[-1]
    if c != len(values) and not (uniform and c == 1):
        raise ValueError(f"{name}: {len(values)} values for {c} channels")
    return torch.tensor(values[:c], dtype=torch.float32, device=data.device)


def scaler(scale_factors: Sequence[float]) -> Transform:
    """Multiply channels by fixed factors (reference preprocessing.py:
    446-474, with its self-assignment bug fixed as in the reference
    package)."""
    factors, uniform = _channel_values(scale_factors)

    def fn(data):
        return (data * _channel_tensor(factors, uniform, data, "scaler"),
                _ones(data))

    return _stage(fn, uniform=uniform)


def min_shifter(chid: int = -1) -> Transform:
    """Subtract the masked min per channel (reference preprocessing.py:
    294-327); chid selects one channel."""

    def planes_fn(x):
        cond = valid_mask(x)
        lo = masked_min(x, cond, dim=(1, 2))[:, None, None]
        return torch.where(cond, x - lo, 0.0), cond.sum(dim=(1, 2)) > 0

    return _stage(lambda data: _per_channel(data, chid, planes_fn),
                  uniform=chid == -1)


def shifter(offsets: Sequence[float]) -> Transform:
    """Subtract fixed per-channel offsets (reference preprocessing.py:
    333-363)."""
    offs, uniform = _channel_values(offsets)

    def fn(data):
        off = _channel_tensor(offs, uniform, data, "shifter")
        return torch.where(valid_mask(data), data - off, 0.0), _ones(data)

    return _stage(fn, uniform=uniform)


def standardizer(means: Sequence[float],
                 sigmas: Sequence[float]) -> Transform:
    """(x - mean) / sigma with fixed per-channel statistics (reference
    preprocessing.py:369-403)."""
    mus, same_mu = _channel_values(means)
    sds, same_sd = _channel_values(sigmas)
    if len(mus) != len(sds):
        raise ValueError(f"standardizer: {len(mus)} means, {len(sds)} "
                         f"sigmas")
    uniform = same_mu and same_sd

    def fn(data):
        mu = _channel_tensor(mus, uniform, data, "standardizer")
        sd = _channel_tensor(sds, uniform, data, "standardizer")
        return (torch.where(valid_mask(data), (data - mu) / sd, 0.0),
                _ones(data))

    return _stage(fn, uniform=uniform)


def negative_data_fixer() -> Transform:
    """Shift a channel with no positive pixel by its masked min (reference
    preprocessing.py:408-440)."""

    def planes_fn(x):
        cond = valid_mask(x)
        lo = masked_min(x, cond, dim=(1, 2))[:, None, None]
        hi = masked_max(x, cond, dim=(1, 2))[:, None, None]
        shifted = torch.where(cond, x - lo, 0.0)
        return (torch.where(hi > 0, x, shifted),
                _ones(x))

    return _stage(lambda data: _per_channel(data, -1, planes_fn),
                  uniform=True)


def log_stretcher(chid: int = -1, minmaxnorm: bool = False,
                  data_norm_min: float = -6.0, data_norm_max: float = 6.0,
                  clip_neg: bool = False) -> Transform:
    """log10 stretch (reference preprocessing.py:480-539), with two of the
    reference's behaviours kept: chid names the channel to SKIP, and with
    minmaxnorm=False masked pixels come out at the channel's log minimum,
    not at 0 (preprocessing.py:524)."""

    def planes_fn(x):
        badpix = (x == 0) | ~torch.isfinite(x)
        cond = (x > 0) & torch.isfinite(x)
        lg = torch.where(cond, torch.log10(torch.where(cond, x, 1.0)), 0.0)
        lg_min = masked_min(lg, cond, dim=(1, 2))[:, None, None]
        lg = torch.where(cond, lg, lg_min)
        if minmaxnorm:
            lg = (lg - data_norm_min) / (data_norm_max - data_norm_min)
            if clip_neg:
                lg = torch.where(lg < 0, 0.0, lg)
            lg = torch.where(badpix, 0.0, lg)
        return lg, cond.sum(dim=(1, 2)) > 0

    return _stage(lambda data: _per_channel(data, chid, planes_fn, skip=True),
                  uniform=chid == -1)


def border_masker(mask_fract: float = 0.7) -> Transform:
    """Zero every pixel outside the centre box (reference
    preprocessing.py:544-586)."""

    def fn(data):
        box = _center_box(*data.shape[1:3], mask_fract, data.device)
        return torch.where(box[None, :, :, None], data, 0.0), _ones(data)

    return _stage(fn, uniform=True)


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] weights of jax.image.resize's "linear" method along one
    axis (scale_and_translate with a triangle kernel, widened by the scale
    when it shrinks: antialiased), normalised per output sample; computed
    on the CPU in f32 as the reference computes them."""
    inv = 1.0 / (n_out / n_in)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    dist = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]
            ).abs() / max(inv, 1.0)
    w = (1 - dist).clamp(min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(device)


def resizer(resize_size: int, upscale: bool = False,
            set_pad_val_to_min: bool = True) -> Transform:
    """Aspect-preserving resize and centred zero pad to a square (reference
    preprocessing.py:776-857).  upscale=False pads a small image instead of
    scaling it up.  The resize is jax.image.resize's linear one, written
    out as its weight matrices (antialiased when it shrinks; a NaN spreads
    over its whole plane, as the reference's contraction spreads it);
    set_pad_val_to_min then sets every masked pixel to its channel's masked
    min."""

    def fn(data):
        _, h, w, _ = data.shape
        scale = 1.0
        if upscale:
            scale = max(1.0, resize_size / min(h, w))
        if round(max(h, w) * scale) > resize_size:
            scale = resize_size / max(h, w)
        nh, nw = round(h * scale), round(w * scale)
        out = data
        if scale != 1.0 and nh != h:
            out = torch.einsum("bhwc,hi->biwc", out,
                               _resize_weights(h, nh, data.device))
        if scale != 1.0 and nw != w:
            out = torch.einsum("bhwc,wj->bhjc", out,
                               _resize_weights(w, nw, data.device))
        top, left = (resize_size - nh) // 2, (resize_size - nw) // 2
        out = F.pad(out, (0, 0, left, resize_size - nw - left,
                          top, resize_size - nh - top))
        if set_pad_val_to_min:
            cond = valid_mask(out)
            mins = masked_min(out, cond, dim=(1, 2))[:, None, None, :]
            out = torch.where(cond, out, mins)
        return out, _ones(data)

    return _stage(fn, uniform=True)


def chan_divider(chref: int = 0, logtransf: bool = False,
                 strip_chref: bool = False, trim: bool = False,
                 trim_min: float = -6.0, trim_max: float = 6.0) -> Transform:
    """Divide the channels by a reference channel (reference
    preprocessing.py:864-928), optionally log10 of the ratios (trimmed),
    optionally dropping the reference channel (whose branch the reference
    package implements correctly)."""

    def fn(data):
        c = data.shape[-1]
        cond = valid_mask(data)
        ref = data[..., chref]
        cond_ref = valid_mask(ref)
        denom = torch.where(ref == 0, 1.0, ref)
        chans = [ref if i == chref
                 else torch.where(cond_ref, data[..., i] / denom, 0.0)
                 for i in range(c)]
        out = torch.where(cond, torch.stack(chans, dim=-1), 0.0)
        if logtransf:
            tr = torch.log10(torch.where(out <= 0, 1.0, out))
            tr = torch.where(cond, tr, 0.0)
            if trim:
                tr = tr.clamp(trim_min, trim_max)
            keep_ref = torch.zeros(c, dtype=torch.bool, device=data.device)
            keep_ref[chref] = True
            out = torch.where(keep_ref, out, tr)
        if strip_chref:
            out = out[..., [i for i in range(c) if i != chref]]
        return out, _ones(data)

    return _stage(fn, uniform=False, reshapes=strip_chref)


def hist_equalizer(adaptive: bool = False,
                   clip_limit: float = 0.03) -> Transform:
    """Per-channel histogram equalisation (reference preprocessing.py:
    977-1012): 256-bin global (kernel K6) or, with adaptive=True, CLAHE
    (kernel K7; skimage equalize_adapthist); masked pixels 0."""

    def eq(planes):
        if adaptive:
            return equalize_adapthist_batch(planes, clip_limit=clip_limit)
        return equalize_hist_batch(planes)

    def fn(data):
        out = _unplanes(eq(_planes(data)), data.shape[0])
        return torch.where(valid_mask(data), out, 0.0), _ones(data)

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
        ok = _ones(data)
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
        return torch.stack(chans, dim=-1), _ones(data)

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
        valid = _ones(data)
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
        ok = _ones(x)
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
