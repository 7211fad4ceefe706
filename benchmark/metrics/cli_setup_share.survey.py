"""Share of the survey fields' wall spent in cli.run outside the
SFinder's phases: parsing, the npz load, the model's build and BatchNorm
fold, the engine's construction (the benchmark's span around
`cli.run.run` minus SFinderReport.phase_times detect + edge_flagging +
stitch + save)."""

LAYER = "CLI and weights (cli/run.py, models/convert.py)"
SOURCE = "program_span"
MOVES = "survey_tiles_per_s"
UNIT = "%"
PHASES = ("detect", "edge_flagging", "stitch", "save")


def read(ctx):
    units = [u for u in ctx.units if u["rc"] == 0]
    wall = sum(u["wall"] for u in units)
    if not wall:
        return None
    inside = sum(u["phase"].get(p, 0.0) for u in units for p in PHASES)
    return 100.0 * (wall - inside) / wall
