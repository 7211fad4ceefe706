"""JSON source-catalog construction and serialization (a copy of
caesar_yolo_tpu/outputs/catalog.py, which the port may not import).

Schema-compatible with the reference's per-image results dict
(reference evaluation.py:418-482: image_id + objs[name, x1, x2, y1, y2,
class_id, class_name, score, edge]) and the mosaic-level sources dict
(reference inference.py:910-929, 1197-1210: sources[..., edge, merged,
tile-provenance fields]).
"""

from __future__ import annotations

import json

import numpy as np

CLASS_NAMES = ("spurious", "compact", "extended", "extended-multisland",
               "flagged")

# matplotlib RGB of each class in the detection plots (outputs/plot.py)
CLASS_COLOR_MAP = {
    "bkg": (0, 0, 0),
    "spurious": (1, 0, 0),
    "compact": (0, 0, 1),
    "extended": (1, 1, 0),
    "extended-multisland": (1, 0.647, 0),
    "flagged": (0, 0, 0),
}

CLASS_COLOR_MAP_DS9 = {
    "bkg": "black",
    "spurious": "red",
    "compact": "blue",
    "extended": "green",
    "extended-multisland": "orange",
    "flagged": "magenta",
}

# mosaic-level map: the reference SFinder uses a DIFFERENT palette than
# the per-tile Analyzer (reference inference.py:334-342 vs
# evaluation.py:108-115): yellow extended-multisland, black flagged,
# and an extra 'diffuse' class
CLASS_COLOR_MAP_DS9_MOSAIC = {
    "bkg": "black",
    "spurious": "red",
    "compact": "blue",
    "extended": "green",
    "extended-multisland": "yellow",
    "flagged": "black",
    "diffuse": "magenta",
}


class NumpyJSONEncoder(json.JSONEncoder):
    """Serialize numpy scalars/arrays transparently (replaces the
    reference's third-party `numpyencoder` dep)."""

    def default(self, obj):
        if isinstance(obj, (np.integer,)):
            return int(obj)
        if isinstance(obj, (np.floating,)):
            return float(obj)
        if isinstance(obj, (np.bool_,)):
            return bool(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)


def make_objects(boxes, scores, class_ids, *, image_shape,
                 xmin: float = 0, ymin: float = 0, name_tag: str = "",
                 class_names=CLASS_NAMES) -> list[dict]:
    """Build the per-image detected-object dicts.

    Boxes are int-truncated and offset into mosaic coords; `edge` flags
    boxes touching the (sub)image bounds (reference evaluation.py:440-468).
    """
    ny, nx = image_shape[:2]
    objs = []
    for i in range(len(boxes)):
        sname = f"S{i + 1}" + (f"_{name_tag}" if name_tag else "")
        x1, y1, x2, y2 = (int(v) for v in boxes[i])
        at_edge = (x1 <= 0 or x1 >= nx - 1 or x2 <= 0 or x2 >= nx - 1
                   or y1 <= 0 or y1 >= ny - 1 or y2 <= 0 or y2 >= ny - 1)
        cid = int(class_ids[i])
        objs.append({
            "name": sname,
            "x1": float(xmin + x1),
            "x2": float(xmin + x2),
            "y1": float(ymin + y1),
            "y2": float(ymin + y2),
            "class_id": cid,
            "class_name": str(class_names[cid]),
            "score": float(scores[i]),
            "edge": int(at_edge),
        })
    return objs


def make_json_results(image_id, objs) -> dict:
    return {"image_id": image_id, "objs": objs}


def write_json(results: dict, outfile: str):
    with open(outfile, "w") as fp:
        json.dump(results, fp, indent=2, sort_keys=True, cls=NumpyJSONEncoder)
