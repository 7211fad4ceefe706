"""Cross-tile edge flagging and duplicate-source stitching (host side).

A copy of caesar_yolo_tpu/parallel/stitch.py: the port may not import the
JAX package, not even its host-only modules.

Reproduces the reference's master-rank stitch semantics exactly
(reference inference.py:663-726 find_sources_at_edge and :731-931
merge_edge_sources): non-edge sources pass through; edge sources form a
graph with edges between bbox-overlapping sources in neighboring tiles;
each connected component collapses to one source — singletons pass
through, multi-member components get the enclosing bbox with class/score
inherited from the largest-area member and edge/merged flags set; the
final list is renamed S1..SN.

N here is the number of edge detections of a whole mosaic (small), so
this is plain numpy + union-find on host.
"""

from __future__ import annotations

import numpy as np

from caesar_yolo_tpu_torch.utils.boxes import boxes_overlap_np, get_merged_bbox
from caesar_yolo_tpu_torch.utils.tiling import TileWindow
from caesar_yolo_tpu_torch.utils.unionfind import connected_components


def flag_edge_sources(objs: list[dict], tile: TileWindow,
                      neighbors: list[TileWindow]) -> None:
    """Set obj['edge']=True for sources at tile bounds or inside a
    neighbor tile's overlap region (reference inference.py:686-726).
    Coordinates are mosaic-frame; never clears an existing flag."""
    for obj in objs:
        x1, x2, y1, y2 = obj["x1"], obj["x2"], obj["y1"], obj["y2"]
        if (x1 == tile.xmin or x2 == tile.xmax
                or y1 == tile.ymin or y2 == tile.ymax):
            obj["edge"] = True
            continue
        for nb in neighbors:
            # tile windows are half-open: a source starting exactly at
            # nb.xmax lies entirely outside nb (its last pixel is
            # nb.xmax-1) and must NOT be edge-flagged; the min side
            # keeps the reference's closed comparison
            not_olap = (x2 < nb.xmin or x1 >= nb.xmax
                        or y2 < nb.ymin or y1 >= nb.ymax)
            if not not_olap:
                obj["edge"] = True
                break


def stitch_tile_sources(tile_results: list[dict]) -> dict:
    """Merge per-tile catalogs into the final mosaic source list.

    tile_results: per-tile dicts with keys objs (catalog objects in
    mosaic coords, edge flags set), tileId, neighborTileIds — the gather
    payload schema of the reference (inference.py:243-255).
    Returns {"sources": [...]} with S1..SN naming.
    """
    sources: list[dict] = []
    edge_refs: list[tuple[int, int]] = []  # (tile_index, obj_index)
    for t_idx, tile_data in enumerate(tile_results):
        for s_idx, obj in enumerate(tile_data["objs"]):
            if not obj.get("edge"):
                obj = dict(obj)
                obj["merged"] = False
                sources.append(obj)
            else:
                edge_refs.append((t_idx, s_idx))

    # Vectorized pair discovery (the reference's O(E^2) python loop,
    # inference.py:757-805, takes minutes at E~1e4 edge sources; the
    # same predicate over numpy row blocks takes milliseconds):
    # pair (i, j>i) is an edge iff j's tile is in i's neighbor list AND
    # the boxes overlap closed-interval (touching DOES merge,
    # reference inference.py:796-801).
    n = len(edge_refs)
    edges = []
    if n:
        boxes = np.asarray(
            [[o["x1"], o["y1"], o["x2"], o["y2"]]
             for o in (tile_results[t]["objs"][s] for t, s in edge_refs)],
            np.float64)
        # neighbor gate over only the tiles that HAVE edge sources
        # (a dense [T, T] matrix would be 10 GB at a 100k-tile run)
        utiles = np.unique([t for t, _ in edge_refs])
        u2row = {int(t): k for k, t in enumerate(utiles)}
        tidx = np.asarray([u2row[t] for t, _ in edge_refs])
        tid2u = {tile_results[int(t)]["tileId"]: u2row[int(t)]
                 for t in utiles}
        nbmat = np.zeros((len(utiles), len(utiles)), bool)
        for t in utiles:
            k = u2row[int(t)]
            for tj in tile_results[int(t)]["neighborTileIds"]:
                if tj in tid2u:
                    nbmat[k, tid2u[tj]] = True
        blk = 2048  # row blocks bound the [E, E] masks at ~blk*E bytes
        for lo in range(0, n, blk):
            hi = min(lo + blk, n)
            pair = (nbmat[tidx[lo:hi]][:, tidx]
                    & boxes_overlap_np(boxes[lo:hi], boxes))
            # strict upper triangle: j > i (global indices)
            pair &= np.arange(n)[None, :] > np.arange(lo, hi)[:, None]
            for i, j in np.argwhere(pair):
                edges.append((int(i) + lo, int(j)))

    for comp in connected_components(n, edges) if n else []:
        if len(comp) == 1:
            t_i, s_i = edge_refs[comp[0]]
            obj = dict(tile_results[t_i]["objs"][s_i])
            obj["merged"] = False
            sources.append(obj)
            continue
        members = [tile_results[t]["objs"][s]
                   for t, s in (edge_refs[k] for k in comp)]
        # largest-area inheritance (reference inference.py:830-860) with
        # a DETERMINISTIC total-order tie-break: equal-area members must
        # resolve identically whatever order tiles were processed in —
        # a crash-resumed run reorders tile_results, and np.argmax's
        # first-wins tie-break would inherit a different score
        # (caught by scripts/drill_banded_resume.py)
        largest = max(members, key=lambda m: (
            (m["x2"] - m["x1"]) * (m["y2"] - m["y1"]),
            m["score"], m["class_id"], m["x1"], m["y1"]))
        x1, y1, x2, y2 = get_merged_bbox(
            [(m["x1"], m["y1"], m["x2"], m["y2"]) for m in members])
        sources.append({
            "name": "merged",
            "x1": float(x1), "x2": float(x2),
            "y1": float(y1), "y2": float(y2),
            "edge": True, "merged": True,
            "score": largest["score"],
            "class_name": largest["class_name"],
            "class_id": largest["class_id"],
        })

    for i, obj in enumerate(sources):
        obj["name"] = f"S{i + 1}"
    return {"sources": sources}
