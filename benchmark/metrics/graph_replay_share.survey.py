"""Share of the survey fields' tile batches that the tile engine ran from
a CUDA graph: 100 x the program's counter `engine.graph_replays` (the
batch each graph was captured on among them) over it plus
`engine.eager_batches`, over the fields that succeeded.  None where the
program counts neither (a program without the graph); 0 on the CPU,
where every batch runs eagerly."""

LAYER = "tile engine (parallel/engine.py)"
SOURCE = "program_counter"
MOVES = "survey_tiles_per_s"
UNIT = "%"
REPLAYS, EAGER = "engine.graph_replays", "engine.eager_batches"


def read(ctx):
    units = [u for u in ctx.units if u["rc"] == 0]
    replays = sum(u["phase"].get(REPLAYS, 0.0) for u in units)
    batches = replays + sum(u["phase"].get(EAGER, 0.0) for u in units)
    if not batches:
        return None
    return 100.0 * replays / batches
