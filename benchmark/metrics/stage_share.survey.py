"""Share of the survey fields' wall staging pixels for the device, by the
program's span `engine.stage`: the f32 copy, the cast to the relay dtype,
`pin_memory` (child `engine.pin`) and the enqueue of the host-to-device
copy of the mosaic, its bands or its tile batches."""

from harness.phases import share

LAYER = "host-to-device staging (parallel/engine.py)"
SOURCE = "program_span"
MOVES = "survey_tiles_per_s"
UNIT = "%"


def read(ctx):
    return share(ctx, ("engine.stage",))
