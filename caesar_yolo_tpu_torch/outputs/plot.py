"""Annotated detection plots (matplotlib, host side).

A copy of caesar_yolo_tpu/outputs/plot.py (the port may not import the
JAX package): the reference's draw_results (reference
evaluation.py:351-411), the image with class-coloured boxes and score
captions.  matplotlib is imported only when a plot is drawn, so runs
without plots never need it.
"""

from __future__ import annotations

import numpy as np

from caesar_yolo_tpu_torch.outputs.catalog import CLASS_COLOR_MAP


def draw_results(image, objs, outfile: str, *,
                 draw_class_label_in_caption: bool = True,
                 show: bool = False):
    """Render detections over the image and save (or show) the figure.

    image: [H, W] or [H, W, C] array; objs: catalog object dicts in
    LOCAL image coords (callers subtract any mosaic offset first).
    """
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import patches

    img = np.asarray(image, np.float32).copy()
    # [0,1]-ish floats scale up; an exact ==1 test left e.g. a zscale
    # output with max 0.97 unscaled, and the integer cast below then
    # floored every pixel to 0 (solid-black plots)
    if img.max() <= 1.0:
        img = img * 255.0
    img = np.clip(img, 0.0, 255.0).astype(np.uint8)

    fig, ax = plt.subplots(1, figsize=(16, 16))
    height, width = img.shape[:2]
    ax.set_ylim(height + 2, -2)
    ax.set_xlim(-2, width + 2)
    ax.axis("off")
    ax.imshow(img)

    for obj in objs:
        x1, y1, x2, y2 = obj["x1"], obj["y1"], obj["x2"], obj["y2"]
        label = obj["class_name"]
        score = obj["score"]
        color = CLASS_COLOR_MAP.get(label, (1, 1, 1))
        rect = patches.Rectangle((x1, y1), x2 - x1, y2 - y1, linewidth=2,
                                 alpha=0.7, linestyle="solid",
                                 edgecolor=color, facecolor="none")
        ax.add_patch(rect)
        if draw_class_label_in_caption:
            ax.text(x1, y1 + 8, f"{label} {score:.2f}", color=color, size=20,
                    backgroundcolor="none")
        else:
            ax.text(x1 + (x2 - x1) / 2 - 4, y1 - 1, f"{score:.2f}",
                    color="darkturquoise", size=30, backgroundcolor="none")

    if show:
        plt.show()
    else:
        fig.savefig(outfile)
        plt.close(fig)
