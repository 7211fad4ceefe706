"""First-party DS9 region-file writer.

A copy of caesar_yolo_tpu/outputs/ds9.py: the port may not import the JAX
package, not even its host-only modules.

Replaces the reference's `regions` package dependency
(reference evaluation.py:487-548, inference.py:1214-1287) with a direct
text serializer: RectanglePixelRegion in image coords becomes
`box(xc,yc,w,h,0)` with the DS9 1-based pixel-origin shift, `text={name}`
and class/BORDER/MERGED tags, and the reference's class color map.
"""

from __future__ import annotations

from caesar_yolo_tpu_torch.outputs.catalog import CLASS_COLOR_MAP_DS9

HEADER = "# Region file format: DS9 astropy/regions\nimage\n"


def region_line(obj: dict, color_map=CLASS_COLOR_MAP_DS9) -> str:
    """One DS9 box region from a detected-object dict (catalog schema)."""
    x1, x2, y1, y2 = obj["x1"], obj["x2"], obj["y1"], obj["y2"]
    dx, dy = x2 - x1, y2 - y1
    # DS9 pixel coordinates are 1-based (FITS origin): +1 shift on centers.
    xc = x1 + 0.5 * dx + 1.0
    yc = y1 + 0.5 * dy + 1.0
    color = color_map.get(obj["class_name"], "white")
    tags = [obj["class_name"]]
    if obj.get("edge"):
        tags.append("BORDER")
    if obj.get("merged"):
        tags.append("MERGED")
    tag_str = " ".join("tag={%s}" % t for t in tags)
    return (f"box({xc:.8g},{yc:.8g},{dx:.8g},{dy:.8g},0) # color={color} "
            f"text={{{obj['name']}}} {tag_str}\n")


def write_ds9_regions(objs, outfile: str, color_map=CLASS_COLOR_MAP_DS9):
    """Write detected-object dicts as a DS9 .reg file (image coordsys).

    `color_map` selects the palette: the per-tile Analyzer map by
    default, CLASS_COLOR_MAP_DS9_MOSAIC for stitched mosaic catalogs
    (the reference uses distinct palettes at the two levels)."""
    with open(outfile, "w") as f:
        f.write(HEADER)
        for obj in objs:
            f.write(region_line(obj, color_map))
