"""Shares of the survey fields' wall read from the program's own totals:
SFinderReport.phase_times (seconds by span name, and the device-clock
counter `engine.device_starved`), which the survey entry keeps in each
field's record under "phase"."""


def share(ctx, add, sub=()):
    """100 * (sum of the `add` totals - sum of the `sub` totals) over the
    fields that succeeded / their wall; None where no such field has any
    key of `add` (a program without these spans or this counter)."""
    units = [u for u in ctx.units if u["rc"] == 0]
    wall = sum(u["wall"] for u in units)
    if not wall or not any(k in u["phase"] for u in units for k in add):
        return None
    total = sum(u["phase"].get(k, 0.0) for u in units for k in add)
    total -= sum(u["phase"].get(k, 0.0) for u in units for k in sub)
    return 100.0 * total / wall
