"""Iterative union-find connected components.

A copy of caesar_yolo_tpu/utils/unionfind.py: the port may not import the JAX
package, not even its host-only modules.

Replaces the reference's recursive-DFS Graph (graph.py:2-41, which risks
hitting the Python recursion limit on large merge graphs) with an
iterative union-find.  Component ordering matches the reference:
components are returned ordered by their smallest vertex index, and
members within a component are listed in ascending index order (the
reference's DFS discovery order differs within a component, but every
consumer reduces over the component so only membership matters; the one
order-sensitive consumer — best-score selection on ties — picks the
lowest index first in both implementations for strict '>' comparisons).
"""

from __future__ import annotations

import numpy as np


class UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x: int) -> int:
        p = self.parent
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:  # path compression
            p[x], x = root, p[x]
        return root

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            # Attach larger-index root under smaller for stable ordering
            if ra < rb:
                self.parent[rb] = ra
            else:
                self.parent[ra] = rb


def connected_components(n: int, edges) -> list[list[int]]:
    """Connected components of an undirected graph with n vertices.

    edges: iterable of (i, j) pairs, or a boolean adjacency matrix [n, n].
    Returns a list of components (lists of vertex indices), ordered by
    smallest member; members ascending.
    """
    uf = UnionFind(n)
    edges = np.asarray(edges) if not isinstance(edges, np.ndarray) else edges
    if edges.ndim == 2 and edges.shape == (n, n):
        ii, jj = np.nonzero(np.triu(edges, k=1))
        pairs = zip(ii.tolist(), jj.tolist())
    else:
        pairs = [tuple(e) for e in edges]
    for i, j in pairs:
        uf.union(int(i), int(j))

    comps: dict[int, list[int]] = {}
    for v in range(n):
        comps.setdefault(uf.find(v), []).append(v)
    return [comps[k] for k in sorted(comps)]
