"""Scene-graph utilities (host-side, tiny N): connected components,
connectivity scores, greedy BA insertion order.

Mirrors util::extract_adj / dfs / computeRowSumDividedByZeroCount
(reference src/system/_util.cpp:454-478,234-249,550-600) and
stch::orderNodesByConnection (_stitch.cpp:8-82).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class Component:
    adj: np.ndarray           # (k,k) upper-triangular weights, local indices
    connectivity: np.ndarray  # (k,) row-sum / zero-count score
    nodes: List[int]          # global indices, sorted


def connectivity_score(adj_sym: np.ndarray) -> np.ndarray:
    """Row sum divided by count of zero entries in the row
    (computeRowSumDividedByZeroCount, _util.cpp:234-249). A denser, stronger
    row scores higher. Zero-count includes the diagonal self-zero."""
    n = adj_sym.shape[0]
    out = np.zeros(n)
    for i in range(n):
        row = adj_sym[i]
        zeros = int(np.sum(row == 0))
        s = float(np.sum(row))
        out[i] = s / zeros if zeros > 0 else s
    return out


def connected_components(adj: np.ndarray) -> List[Component]:
    """Symmetrize, DFS components, per-component upper-tri adjacency +
    connectivity, sorted by node count descending (extract_adj)."""
    if adj.size == 0:
        raise ValueError("Input matrix is empty")
    if adj.shape[0] != adj.shape[1]:
        raise ValueError("Input matrix is not square")
    n = adj.shape[0]
    sym = adj + adj.T
    seen = [False] * n
    comps: List[List[int]] = []
    for s in range(n):
        if seen[s]:
            continue
        stack, comp = [s], []
        while stack:
            u = stack.pop()
            if seen[u]:
                continue
            seen[u] = True
            comp.append(u)
            for v in range(n - 1, -1, -1):
                if sym[u, v] != 0 and not seen[v]:
                    stack.append(v)
        comps.append(sorted(comp))

    out = []
    for nodes in comps:
        idx = np.asarray(nodes)
        sub_sym = sym[np.ix_(idx, idx)]
        sub_upper = np.triu(sub_sym)  # store upper triangle like reference
        out.append(Component(adj=sub_upper,
                             connectivity=connectivity_score(sub_sym),
                             nodes=nodes))
    out.sort(key=lambda c: len(c.nodes), reverse=True)
    return out


def order_nodes_by_connection(adj_sym: np.ndarray) -> List[Tuple[int, int]]:
    """Greedy insertion order: start at the max-weighted-degree node, then
    repeatedly add the unadded node with the strongest single edge into the
    added set. Returns [(node_added, connected_to)], first entry has
    connected_to = -1 (orderNodesByConnection, _stitch.cpp:8-82)."""
    n = adj_sym.shape[0]
    if n == 0:
        return []
    weights = np.where(adj_sym > 0, adj_sym, 0.0)
    np.fill_diagonal(weights, 0.0)
    first = int(np.argmax(weights.sum(axis=1)))
    added = [False] * n
    added[first] = True
    result = [(first, -1)]
    while len(result) < n:
        best_strength, nxt, conn = -1.0, -1, -1
        for cand in range(n):
            if added[cand]:
                continue
            cur_max, cur_conn = -1.0, -1
            for a in range(n):
                if added[a] and adj_sym[cand, a] > 0 and adj_sym[cand, a] > cur_max:
                    cur_max, cur_conn = adj_sym[cand, a], a
            if cur_max > 0 and cur_max > best_strength:
                best_strength, nxt, conn = cur_max, cand, cur_conn
        if nxt < 0:
            break  # disconnected remainder
        added[nxt] = True
        result.append((nxt, conn))
    return result
