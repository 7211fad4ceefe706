"""Share of the training window's wall spent in next() on the
DetectionDataset iterator (the benchmark's span around it): the loader's
read, min-max and stack that the prefetch did not hide."""

LAYER = "dataset (train/dataset.py)"
SOURCE = "host_clock"
MOVES = "train_images_per_s"
UNIT = "%"


def read(ctx):
    if ctx.window_s <= 0:
        return None
    t0 = ctx.window_t0
    waits = sum(b - a for n, a, b in ctx.spans.done
                if n == "data_wait" and a >= t0)
    return 100.0 * waits / ctx.window_s
