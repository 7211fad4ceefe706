"""Share of the survey fields' wall in which the device's stream sat empty
between consecutive batches of a field, waiting for the host: the
program's counter `engine.device_starved`, read from timing events on the
device's own clock (the end of batch k-1 to the start of batch k).  Part
of device_idle.survey; absent on the CPU."""

from harness.phases import share

LAYER = "device"
SOURCE = "program_counter"
MOVES = "survey_tiles_per_s"
UNIT = "%"


def read(ctx):
    return share(ctx, ("engine.device_starved",))
