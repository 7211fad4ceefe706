"""Share of the survey fields' wall dispatching tile batches, by the
program's span `engine.dispatch`: the windows' origins to the device
(child `engine.origins`, a copy that waits for the stream), the window
gather and the launches of the batch's step."""

from harness.phases import share

LAYER = "tile engine (parallel/engine.py)"
SOURCE = "program_span"
MOVES = "survey_tiles_per_s"
UNIT = "%"


def read(ctx):
    return share(ctx, ("engine.dispatch",))
