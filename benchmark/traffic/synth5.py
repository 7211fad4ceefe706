"""Five-class synthetic radio-source cutouts (training traffic).

Frozen from the program's `utils/synth5.py` (the same draws from a
torch.Generator on the CPU and the same field formulas, rendered in plain
PyTorch), so a later change to the program cannot change the traffic.
The five classes are the reference dataset's: spurious, compact,
extended, extended-multisland, flagged; a cutout holds 0-4 sources on a
jittered 2x2 grid, each box the 2-sigma extent of its morphology.  A
traffic file names: n_images, size (132, the reference dataset's cutout
size), max_src, noise.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from traffic.mosaic import write_fits

# Reference class ids / names (README.md:154-161).
CLASS_NAMES = ("spurious", "compact", "extended", "extended-multisland",
               "flagged")
NATIVE_SIZE = 132  # the reference dataset's cutout size (README.md:163)

# jittered 2x2 quadrant anchors, in units of the cutout size
_QUADS = ((0.3, 0.3), (0.7, 0.3), (0.3, 0.7), (0.7, 0.7))
_ISLANDS = 3


def draw_multiclass_params(gen: torch.Generator, batch: int, *,
                           size: int = NATIVE_SIZE, max_src: int = 4,
                           noise: float = 0.08) -> dict:
    """Every random value of `batch` cutouts, from `gen` on its device:

    noise   [B, size, size] f32, the noise plane (noise * N(0, 1))
    n_src   [B] int64 in [0, max_src], the sources present
    perm    [B, max_src] int64, the quadrant of each slot
    cls     [B, max_src] int64 in [0, 4]
    jitter  [B, max_src, 2] f32 in [-0.08 size, 0.08 size), x and y
    theta   [B, max_src] f32 in [0, pi)
    t       [B, max_src, 8] f32 in [0, 1), the shape parameters
    phi_u, sig_u, amp_u
            [B, max_src, 3] f32 in [0, 1), the islands' angle offsets,
            widths and amplitudes (extended-multisland)
    """
    dev = gen.device
    jit_amp = 0.08 * size

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    plane = noise * torch.randn((batch, size, size), generator=gen,
                                device=dev)
    n_src = torch.randint(0, max_src + 1, (batch,), generator=gen,
                          device=dev)
    perm = torch.argsort(rand(batch, 4), dim=1)[:, :max_src]
    cls = torch.randint(0, 5, (batch, max_src), generator=gen, device=dev)
    return {"noise": plane, "n_src": n_src, "perm": perm, "cls": cls,
            "jitter": rand(batch, max_src, 2) * (2 * jit_amp) - jit_amp,
            "theta": rand(batch, max_src) * math.pi,
            "t": rand(batch, max_src, 8),
            "phi_u": rand(batch, max_src, _ISLANDS),
            "sig_u": rand(batch, max_src, _ISLANDS),
            "amp_u": rand(batch, max_src, _ISLANDS)}


def _ellipse_extents(sa, sb, ct, st):
    """Axis-aligned half extents of the 2-sigma rotated ellipse."""
    hx = 2.0 * torch.sqrt((sa * ct) ** 2 + (sb * st) ** 2)
    hy = 2.0 * torch.sqrt((sa * st) ** 2 + (sb * ct) ** 2)
    return hx, hy


def _slot_shapes(draws: dict, size: int) -> dict:
    """Each slot's geometry (render_slot, synth5.py:76-157): its centre
    cx, cy [B, S], rotation ct, st, the five classes' shape parameters,
    and their 2-sigma half extents hx, hy [5, B, S] in class order.  The
    ground truth depends on these alone, not on the fields."""
    dev = draws["noise"].device
    px = size / float(NATIVE_SIZE)  # morphology params scale with size
    qc = torch.tensor(_QUADS, dtype=torch.float32, device=dev) * size
    quad = qc[draws["perm"]]                                  # [B, S, 2]
    cx = quad[..., 0] + draws["jitter"][..., 0]
    cy = quad[..., 1] + draws["jitter"][..., 1]
    theta, t = draws["theta"], draws["t"]
    ct, st = torch.cos(theta), torch.sin(theta)
    tk = [t[..., i] for i in range(8)]

    # -- 1 compact: beam-sized, near-circular
    sa_c = (2.0 + 2.0 * tk[0]) * px
    sb_c = sa_c / (1.0 + 0.3 * tk[1])
    amp_c = 1.0 + 4.0 * tk[2]
    hx_c, hy_c = _ellipse_extents(sa_c, sb_c, ct, st)

    # -- 2 extended: elongated + secondary diffuse component
    sa_e = (6.0 + 5.0 * tk[0]) * px
    sb_e = sa_e / (2.2 + 1.8 * tk[1])
    amp_e = 0.6 + 1.9 * tk[2]
    off_e = 0.8 * sa_e * (2.0 * tk[3] - 1.0)
    hx_e, hy_e = _ellipse_extents(sa_e, sb_e, ct, st)

    # -- 3 extended-multisland: 3 disjoint islands, ONE gt box
    ks = torch.arange(_ISLANDS, dtype=torch.float32, device=dev)
    phis = (theta[..., None] + ks * (2.0 * np.pi / _ISLANDS)
            + 0.3 * (2.0 * draws["phi_u"] - 1.0))
    rad = (7.0 + 5.0 * tk[4]) * px
    ox = rad[..., None] * torch.cos(phis)
    oy = rad[..., None] * torch.sin(phis)
    sig_k = (2.0 + 1.0 * draws["sig_u"]) * px
    amp_k = (1.0 + 3.0 * tk[5])[..., None] * (0.7 + 0.3 * draws["amp_u"])
    hx_m = (ox.abs() + 2.0 * sig_k).amax(-1)
    hy_m = (oy.abs() + 2.0 * sig_k).amax(-1)

    # -- 0 spurious: low-amplitude PSF sidelobe ring pattern
    r0 = (4.0 + 4.0 * tk[0]) * px
    amp_s = 0.35 + 0.65 * tk[2]
    hx_s = hy_s = 1.5 * r0

    # -- 4 flagged: bright compact + linear artifact stripe
    sa_f = (2.0 + 1.5 * tk[0]) * px
    amp_f = 3.0 + 5.0 * tk[2]
    wl = (7.0 + 6.0 * tk[3]) * px
    ww = (1.0 + 1.0 * tk[4]) * px
    hx_f = torch.maximum(2.0 * sa_f,
                         2.0 * wl * ct.abs() + 2.0 * ww * st.abs())
    hy_f = torch.maximum(2.0 * sa_f,
                         2.0 * wl * st.abs() + 2.0 * ww * ct.abs())

    return {"cx": cx, "cy": cy, "ct": ct, "st": st,
            "sa_c": sa_c, "sb_c": sb_c, "amp_c": amp_c,
            "sa_e": sa_e, "sb_e": sb_e, "amp_e": amp_e, "off_e": off_e,
            "ox": ox, "oy": oy, "sig_k": sig_k, "amp_k": amp_k,
            "r0": r0, "amp_s": amp_s,
            "sa_f": sa_f, "amp_f": amp_f, "wl": wl, "ww": ww,
            "hx": torch.stack([hx_s, hx_c, hx_e, hx_m, hx_f]),
            "hy": torch.stack([hy_s, hy_c, hy_e, hy_m, hy_f])}


def _slot_fields(sh: dict, size: int) -> torch.Tensor:
    """The five field formulas of every slot (render_slot,
    synth5.py:76-157) on `_slot_shapes`' geometry -> [5, B, S, size,
    size] in class order."""
    dev = sh["cx"].device
    grid = torch.arange(size, dtype=torch.float32, device=dev)
    yy, xx = grid[:, None], grid[None, :]
    ct, st = sh["ct"], sh["st"]

    def e(a):  # a per-slot value against the [size, size] grid
        return a[..., None, None]

    dx, dy = xx - e(sh["cx"]), yy - e(sh["cy"])
    u = dx * e(ct) + dy * e(st)
    v = -dx * e(st) + dy * e(ct)
    r = torch.sqrt(u * u + v * v + 1e-9)

    # -- 1 compact
    f_c = e(sh["amp_c"]) * torch.exp(-0.5 * (u ** 2 / e(sh["sa_c"]) ** 2
                                             + v ** 2 / e(sh["sb_c"]) ** 2))

    # -- 2 extended
    sa_e, sb_e, amp_e = sh["sa_e"], sh["sb_e"], sh["amp_e"]
    f_e = (e(amp_e) * torch.exp(-0.5 * (u ** 2 / e(sa_e) ** 2
                                        + v ** 2 / e(sb_e) ** 2))
           + e(0.5 * amp_e) * torch.exp(
               -0.5 * ((u - e(sh["off_e"])) ** 2 / e(0.6 * sa_e) ** 2
                       + v ** 2 / e(sb_e) ** 2)))

    # -- 3 extended-multisland
    ox, oy, sig_k, amp_k = sh["ox"], sh["oy"], sh["sig_k"], sh["amp_k"]
    f_m = sum(e(amp_k[..., k]) * torch.exp(
        -((dx - e(ox[..., k])) ** 2 + (dy - e(oy[..., k])) ** 2)
        / e(2.0 * sig_k[..., k] ** 2)) for k in range(_ISLANDS))

    # -- 0 spurious
    r0 = sh["r0"]
    f_s = e(sh["amp_s"]) * torch.cos(np.pi * r / e(r0)) \
        * torch.exp(-r ** 2 / e(2.0 * (1.2 * r0) ** 2))

    # -- 4 flagged
    amp_f, ww, wl = sh["amp_f"], sh["ww"], sh["wl"]
    f_f = e(amp_f) * torch.exp(-0.5 * (u ** 2 + v ** 2)
                               / e(sh["sa_f"]) ** 2) \
        + e(0.35 * amp_f) * torch.exp(-0.5 * (v ** 2 / e(ww) ** 2
                                              + u ** 2 / e(wl) ** 2))

    return torch.stack([f_s, f_c, f_e, f_m, f_f])


def render_multiclass(draws: dict, *, size: int = NATIVE_SIZE,
                      max_src: int = 4):
    """Draws (`draw_multiclass_params`) -> (img3 [B, size, size, 3] f32 in
    [0, 1], labels [B, max_src] int64, boxes [B, max_src, 4] xyxy in
    cutout pixels, mask [B, max_src] bool), on the draws' device.

    Each slot's field and box are its class's, selected by a one-hot mask
    as the reference does; masked slots add nothing; the slots are added
    to the noise plane in slot order and the sum is min-max normalised
    (the FITS load convention of train/dataset.load_sample)."""
    sh = _slot_shapes(draws, size)
    cls, boxes, mask = _ground_truth(draws, sh, size, max_src)
    onehot = torch.arange(5, device=cls.device)[:, None, None] == cls
    field = torch.where(onehot[..., None, None], _slot_fields(sh, size),
                        0.0).sum(0)
    img = draws["noise"]
    for j in range(max_src):
        img = img + torch.where(mask[:, j, None, None], field[:, j], 0.0)
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    img = (img - lo) / torch.clamp(hi - lo, min=1e-6)
    return img[..., None].repeat(1, 1, 1, 3), cls, boxes, mask


def _ground_truth(draws: dict, sh: dict, size: int, max_src: int):
    """Each slot's class, its class's box from `_slot_shapes` (clamped to
    the cutout) and the mask of the slots present."""
    cls = draws["cls"]
    onehot = torch.arange(5, device=cls.device)[:, None, None] == cls
    hx = torch.where(onehot, sh["hx"], 0.0).sum(0)
    hy = torch.where(onehot, sh["hy"], 0.0).sum(0)
    cx, cy = sh["cx"], sh["cy"]
    boxes = torch.stack([cx - hx, cy - hy, cx + hx, cy + hy], dim=-1)
    boxes = boxes.clamp(0.0, float(size))
    mask = torch.arange(max_src, device=cls.device) < draws["n_src"][:, None]
    return cls, boxes, mask


def write_dataset(directory: str, seed: int, n_images: int,
                  size: int = NATIVE_SIZE, max_src: int = 4,
                  noise: float = 0.08, device="cpu", **_):
    """Render `n_images` cutouts from `seed` (draws on the CPU, so a seed
    gives the same cutouts on every device; rendered on `device` in
    chunks) and write the ultralytics layout the program's loader reads:
    images/c<i>.fits, labels/c<i>.txt (class cx cy w h, normalised, six
    decimals) and dataset.yaml.  -> (images [N, size, size] f32, the label
    lines of each image)."""
    img_dir = os.path.join(directory, "images")
    lab_dir = os.path.join(directory, "labels")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)
    gen = torch.Generator().manual_seed(int(seed))
    draws = draw_multiclass_params(gen, n_images, size=size,
                                   max_src=max_src, noise=noise)
    images, lines_all = [], []
    for lo in range(0, n_images, 64):
        part = {k: v[lo:lo + 64].to(device) for k, v in draws.items()}
        img3, labels, boxes, mask = (
            t.cpu().numpy()
            for t in render_multiclass(part, size=size, max_src=max_src))
        for i in range(len(img3)):
            images.append(img3[i, :, :, 0].astype(np.float32))
            lines = []
            for j in range(max_src):
                if mask[i, j]:
                    x0, y0, x1, y1 = boxes[i, j]
                    lines.append(
                        f"{int(labels[i, j])} {(x0 + x1) / 2.0 / size:.6f} "
                        f"{(y0 + y1) / 2.0 / size:.6f} "
                        f"{(x1 - x0) / size:.6f} {(y1 - y0) / size:.6f}")
            lines_all.append(lines)
    for i, (img, lines) in enumerate(zip(images, lines_all)):
        write_fits(img, os.path.join(img_dir, f"c{i:05d}.fits"),
                   (("BUNIT", "JY/BEAM"),))
        with open(os.path.join(lab_dir, f"c{i:05d}.txt"), "w") as fh:
            fh.write("\n".join(lines) + ("\n" if lines else ""))
    with open(os.path.join(directory, "dataset.yaml"), "w") as fh:
        fh.write(f"path: {directory}\ntrain: images\nnames:\n" + "".join(
            f"  {i}: {n}\n" for i, n in enumerate(CLASS_NAMES)))
    return np.stack(images), lines_all
