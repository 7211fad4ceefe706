"""How unevenly the ranks of a striped survey run detect: 100 x the
slowest rank's `detect` span over the ranks' mean, each rank's spans
summed over the fields that succeeded (100 when the ranks are even).  The
four-rank entry keeps each rank's span totals in a field's record under
"ranks"; None without them."""

LAYER = "ranks (parallel/mesh.py, parallel/sfinder.py)"
SOURCE = "program_span"
MOVES = "survey_tiles_per_s"
UNIT = "%"
SPAN = "detect"


def read(ctx):
    units = [u for u in ctx.units if u["rc"] == 0 and u.get("ranks")]
    if not units:
        return None
    per_rank = [sum(u["ranks"][r].get(SPAN, 0.0) for u in units)
                for r in range(len(units[0]["ranks"]))]
    mean = sum(per_rank) / len(per_rank)
    if mean <= 0:
        return None
    return 100.0 * max(per_rank) / mean
