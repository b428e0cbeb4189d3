"""Fanout neighbor sampler over the CSR store, the reference's
``graphdb/sampler.py`` copied unchanged (numpy only: the same
``np.random.Generator`` gives the same arrays).

This is the data pipeline for the ``minibatch_lg`` GNN shape (GraphSAGE-style
fanout sampling, e.g. 15-10). It is deliberately built on the same CSR arrays
the pattern engine expands — GOpt's EXPAND with sampling — which is the point
of contact between the paper's engine and the assigned GNN architectures
(DESIGN.md §4).

Returns padded, fixed-shape arrays ready for a train step:
  nodes:   int32[max_nodes]      (global ids, -1 pad; seeds first)
  edges:   int32[2, max_edges]   (COO into the *local* node index, -1 pad)
  n_nodes, n_edges: actual counts
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class HomoCSR:
    """A homogeneous (single node type) CSR graph for GNN workloads."""
    indptr: np.ndarray
    indices: np.ndarray
    n_nodes: int

    @staticmethod
    def from_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                   symmetric: bool = True) -> "HomoCSR":
        if symmetric:
            src, dst = (np.concatenate([src, dst]),
                        np.concatenate([dst, src]))
        order = np.lexsort((dst, src))
        src, dst = src[order], dst[order]
        indptr = np.zeros(n_nodes + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        return HomoCSR(np.cumsum(indptr), dst.astype(np.int64), n_nodes)


def sample_fanout(csr: HomoCSR, seeds: np.ndarray, fanouts: list[int],
                  rng: np.random.Generator,
                  max_nodes: int, max_edges: int):
    """Multi-hop uniform fanout sampling; dedupes nodes per layer."""
    nodes = list(seeds.astype(np.int64))
    node_pos = {int(n): i for i, n in enumerate(nodes)}
    e_src, e_dst = [], []
    frontier = seeds.astype(np.int64)
    for f in fanouts:
        nxt = []
        if frontier.size == 0:
            break
        deg = csr.indptr[frontier + 1] - csr.indptr[frontier]
        for u, d in zip(frontier, deg):
            if d == 0:
                continue
            k = min(int(d), f)
            sel = (rng.choice(int(d), size=k, replace=False) if d > f
                   else np.arange(int(d)))
            nbrs = csr.indices[csr.indptr[u] + sel]
            for v in nbrs:
                v = int(v)
                if v not in node_pos:
                    if len(nodes) >= max_nodes:
                        continue
                    node_pos[v] = len(nodes)
                    nodes.append(v)
                if len(e_src) < max_edges:
                    # message flows neighbor -> center
                    e_src.append(node_pos[v])
                    e_dst.append(node_pos[int(u)])
                nxt.append(v)
        frontier = np.unique(np.asarray(nxt, dtype=np.int64))

    n_nodes, n_edges = len(nodes), len(e_src)
    nodes_arr = np.full(max_nodes, -1, dtype=np.int32)
    nodes_arr[:n_nodes] = nodes
    edges_arr = np.full((2, max_edges), -1, dtype=np.int32)
    if n_edges:
        edges_arr[0, :n_edges] = e_src
        edges_arr[1, :n_edges] = e_dst
    return nodes_arr, edges_arr, n_nodes, n_edges


def random_power_law_graph(n_nodes: int, avg_degree: int, seed: int = 0,
                           zipf_a: float = 1.5) -> HomoCSR:
    """Synthetic graph with power-law in-degree (test/bench substrate)."""
    rng = np.random.default_rng(seed)
    m = n_nodes * avg_degree // 2
    src = rng.integers(0, n_nodes, size=m, dtype=np.int64)
    ranks = rng.zipf(zipf_a, size=m).astype(np.int64)
    dst = (ranks - 1) % n_nodes
    keep = src != dst
    return HomoCSR.from_edges(src[keep], dst[keep], n_nodes)
