"""Share of the survey fields' wall the host waits on the device for a
batch's outputs, by the program's span `sfinder.drain_wait`: the copies
of the outputs to the host, which return once the device is done."""

from harness.phases import share

LAYER = "tile engine (parallel/engine.py)"
SOURCE = "program_span"
MOVES = "survey_tiles_per_s"
UNIT = "%"


def read(ctx):
    return share(ctx, ("sfinder.drain_wait",))
