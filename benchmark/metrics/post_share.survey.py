"""Share of the survey fields' wall spent after detection: edge flags,
the stitch and writing the catalog and regions (SFinderReport.phase_times
edge_flagging + stitch + save)."""

LAYER = "edge flags, stitch, catalog (parallel/stitch.py, outputs/)"
SOURCE = "program_span"
MOVES = "survey_tiles_per_s"
UNIT = "%"
PHASES = ("edge_flagging", "stitch", "save")


def read(ctx):
    units = [u for u in ctx.units if u["rc"] == 0]
    wall = sum(u["wall"] for u in units)
    if not wall:
        return None
    return 100.0 * sum(u["phase"].get(p, 0.0) for u in units
                       for p in PHASES) / wall
