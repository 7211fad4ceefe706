"""Share of the survey fields' wall spent reading the field
(SFinderReport.read_s: the FITS read of the mosaic, or of its bands or
windows)."""

LAYER = "image read (utils/fits.py)"
SOURCE = "program_span"
MOVES = "survey_tiles_per_s"
UNIT = "%"


def read(ctx):
    units = [u for u in ctx.units if u["rc"] == 0]
    wall = sum(u["wall"] for u in units)
    return 100.0 * sum(u["read_s"] for u in units) / wall if wall else None
