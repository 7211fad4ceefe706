"""Share of the area-attention calls of the survey fields that took K2:
100 x the program's counter `model.area_attn_fused` over it plus
`model.area_attn_plain` (models/layers.py:area_attention; a replayed CUDA
graph advances both by what its capture counted), over the fields that
succeeded.  None where the program counts neither (a model without area
attention, or a program without the counters)."""

LAYER = "model (models/yolo.py, models/layers.py)"
SOURCE = "program_counter"
MOVES = "survey_tiles_per_s"
UNIT = "%"
FUSED, PLAIN = "model.area_attn_fused", "model.area_attn_plain"


def read(ctx):
    units = [u for u in ctx.units if u["rc"] == 0]
    fused = sum(u["phase"].get(FUSED, 0.0) for u in units)
    calls = fused + sum(u["phase"].get(PLAIN, 0.0) for u in units)
    if not calls:
        return None
    return 100.0 * fused / calls
