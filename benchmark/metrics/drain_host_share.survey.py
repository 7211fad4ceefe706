"""Share of the survey fields' wall the host spends on drained batches
after their outputs arrive: the program's span `sfinder.drain` less its
child `sfinder.drain_wait` (the per-tile merge, catalog objects and the
spool's writes)."""

from harness.phases import share

LAYER = "edge flags, stitch, catalog (parallel/stitch.py, outputs/)"
SOURCE = "program_span"
MOVES = "survey_tiles_per_s"
UNIT = "%"


def read(ctx):
    return share(ctx, ("sfinder.drain",), ("sfinder.drain_wait",))
