"""Columnar property-graph storage.

Vertices get global ids range-partitioned by type (type t owns
``[v_offset[t], v_offset[t]+v_count[t])``), so SCAN is an iota and the type of
an id is a ``searchsorted``. Each edge triple (src_type, label, dst_type) is
stored as a *sorted-CSR pair* (out of src, in of dst) — sorted adjacency is
what enables the worst-case-optimal intersection step (and the CUDA
``wcoj_intersect`` kernel's per-row binary search).

indptr/indices are plain arrays with no pointers. The store lives in host
numpy; the torch operator set uploads int32 device twins of what it
touches.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.schema import EdgeTriple, GraphSchema


@dataclasses.dataclass
class CSR:
    """One direction of one edge triple. indices are *global* vertex ids,
    sorted within each row. ``pos``: for the IN direction, position of each
    entry in the OUT direction's indices (edge identity for properties)."""
    indptr: np.ndarray      # int64[n_rows+1] over local ids of the keyed type
    indices: np.ndarray     # int64[nnz] global neighbor ids (sorted per row)
    pos: np.ndarray | None = None   # int64[nnz] edge position in OUT order

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)


@dataclasses.dataclass
class GraphStore:
    schema: GraphSchema
    v_offset: dict[str, int]            # type -> first global id
    v_count: dict[str, int]
    out_csr: dict[EdgeTriple, CSR]
    in_csr: dict[EdgeTriple, CSR]
    # vertex properties: type -> prop -> int64 column (strings dict-encoded)
    v_props: dict[str, dict[str, np.ndarray]]
    # edge properties: triple -> prop -> int64 column aligned with OUT order
    e_props: dict[EdgeTriple, dict[str, np.ndarray]]
    str_vocab: dict[str, dict[str, int]]  # prop name -> string -> code

    # ------------------------------------------------------------------ meta
    @property
    def n_vertices(self) -> int:
        return sum(self.v_count.values())

    @property
    def n_edges(self) -> int:
        return sum(c.nnz for c in self.out_csr.values())

    def type_range(self, vtype: str) -> tuple[int, int]:
        o = self.v_offset[vtype]
        return o, o + self.v_count[vtype]

    def _sorted_types(self):
        return sorted(self.v_offset, key=lambda t: self.v_offset[t])

    def type_of_ids(self, ids: np.ndarray) -> np.ndarray:
        """Type *index* (into sorted_types order) for each global id."""
        types = self._sorted_types()
        bounds = np.array([self.v_offset[t] for t in types] +
                          [self.n_vertices], dtype=np.int64)
        return np.searchsorted(bounds, ids, side="right") - 1

    def encode_str(self, prop: str, value: str) -> int:
        return self.str_vocab.get(prop, {}).get(value, -1)

    # -------------------------------------------------------------- property
    def vertex_prop(self, ids: np.ndarray, prop: str) -> np.ndarray:
        """Gather property values for global ids (possibly of mixed type).
        Missing (type has no such prop) -> INT64_MIN sentinel."""
        out = np.full(ids.shape, np.iinfo(np.int64).min, dtype=np.int64)
        types = self._sorted_types()
        tidx = self.type_of_ids(ids)
        for i, t in enumerate(types):
            col = self.v_props.get(t, {}).get(prop)
            if col is None:
                continue
            m = tidx == i
            if not m.any():
                continue
            out[m] = col[ids[m] - self.v_offset[t]]
        return out

    def edge_prop(self, triple_ids: np.ndarray, pos: np.ndarray,
                  prop: str) -> np.ndarray:
        out = np.full(pos.shape, np.iinfo(np.int64).min, dtype=np.int64)
        triples = sorted(self.out_csr, key=repr)
        for i, t in enumerate(triples):
            col = self.e_props.get(t, {}).get(prop)
            if col is None:
                continue
            m = triple_ids == i
            if not m.any():
                continue
            out[m] = col[pos[m]]
        return out

    def triple_index(self) -> dict[EdgeTriple, int]:
        return {t: i for i, t in enumerate(sorted(self.out_csr, key=repr))}


def build_store(schema: GraphSchema,
                v_count: dict[str, int],
                edges: dict[EdgeTriple, tuple[np.ndarray, np.ndarray]],
                v_props: dict[str, dict[str, np.ndarray]] | None = None,
                e_props: dict[EdgeTriple, dict[str, np.ndarray]] | None = None,
                str_vocab: dict[str, dict[str, int]] | None = None,
                ) -> GraphStore:
    """Assemble a GraphStore from per-triple (src_local, dst_local) edge lists.

    ``edges[t] = (src_local_ids, dst_local_ids)`` with local ids in
    ``[0, v_count[type])``. Duplicate edges are removed.
    """
    v_offset, off = {}, 0
    for t in schema.vertex_types:
        v_offset[t] = off
        off += int(v_count.get(t, 0))

    out_csr: dict[EdgeTriple, CSR] = {}
    in_csr: dict[EdgeTriple, CSR] = {}
    e_props = dict(e_props or {})
    for triple, (src, dst) in edges.items():
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        ns, nd = v_count[triple.src], v_count[triple.dst]
        if src.size:
            if src.max() >= ns or dst.max() >= nd:
                raise ValueError(f"edge endpoints out of range for {triple}")
        # dedupe
        key = src * nd + dst
        key, uniq_idx = np.unique(key, return_index=True)
        src, dst = key // nd, key % nd
        gsrc = src + v_offset[triple.src]
        gdst = dst + v_offset[triple.dst]
        # out CSR (rows = src local, sorted by (src, gdst) — unique already is)
        indptr = np.zeros(ns + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        indptr = np.cumsum(indptr)
        out_csr[triple] = CSR(indptr, gdst.copy())
        # edge props follow the dedupe/sort order
        if triple in e_props:
            e_props[triple] = {k: np.asarray(v)[uniq_idx]
                               for k, v in e_props[triple].items()}
        # in CSR: sort by (dst, gsrc); remember out-order position
        order = np.lexsort((gsrc, dst))
        indptr_in = np.zeros(nd + 1, dtype=np.int64)
        np.add.at(indptr_in, dst + 1, 1)
        indptr_in = np.cumsum(indptr_in)
        in_csr[triple] = CSR(indptr_in, gsrc[order], pos=order.astype(np.int64))

    return GraphStore(schema=schema, v_offset=v_offset,
                      v_count={t: int(v_count.get(t, 0))
                               for t in schema.vertex_types},
                      out_csr=out_csr, in_csr=in_csr,
                      v_props=v_props or {}, e_props=e_props,
                      str_vocab=str_vocab or {})


def encode_strings(values: list[str], vocab: dict[str, int]) -> np.ndarray:
    out = np.empty(len(values), dtype=np.int64)
    for i, v in enumerate(values):
        if v not in vocab:
            vocab[v] = len(vocab)
        out[i] = vocab[v]
    return out


# ------------------------------------------------------------ state carried
# A store as plain data: numpy arrays, ints, strings, tuples and dicts of
# them, with edge triples as (src, label, dst) tuples.  Any object with a
# GraphStore's attributes flattens through ``export_store``, so a store
# built by another package crosses into this one as the same bytes.

def _triple_key(t) -> tuple[str, str, str]:
    return (t.src, t.label, t.dst)


def export_store(store) -> dict:
    """Flatten a GraphStore-shaped object into plain arrays and dicts."""
    sch = store.schema
    return {
        "schema": {
            "vertex_types": tuple(sch.vertex_types),
            "edge_triples": tuple(_triple_key(t) for t in sch.edge_triples),
            "vertex_props": {t: dict(p) for t, p in sch.vertex_props.items()},
            "edge_props": {t: dict(p) for t, p in sch.edge_props.items()},
        },
        "v_offset": dict(store.v_offset),
        "v_count": dict(store.v_count),
        "csr": {_triple_key(t): {
            "out_indptr": store.out_csr[t].indptr,
            "out_indices": store.out_csr[t].indices,
            "in_indptr": store.in_csr[t].indptr,
            "in_indices": store.in_csr[t].indices,
            "in_pos": store.in_csr[t].pos,
        } for t in store.out_csr},
        "v_props": {t: dict(p) for t, p in store.v_props.items()},
        "e_props": {_triple_key(t): dict(p)
                    for t, p in store.e_props.items()},
        "str_vocab": {k: dict(v) for k, v in store.str_vocab.items()},
    }


def import_store(arrays: dict) -> GraphStore:
    """Rebuild a GraphStore from ``export_store``'s plain data.  Arrays are
    taken as int64 numpy (copied only where the dtype differs), so both
    sides of a parity test compute over the same values."""
    def i64(a):
        return None if a is None else np.asarray(a, dtype=np.int64)

    s = arrays["schema"]
    schema = GraphSchema(
        vertex_types=tuple(s["vertex_types"]),
        edge_triples=tuple(EdgeTriple(*t) for t in s["edge_triples"]),
        vertex_props={t: dict(p) for t, p in s["vertex_props"].items()},
        edge_props={t: dict(p) for t, p in s["edge_props"].items()})
    out_csr, in_csr = {}, {}
    for key, c in arrays["csr"].items():
        t = EdgeTriple(*key)
        out_csr[t] = CSR(i64(c["out_indptr"]), i64(c["out_indices"]))
        in_csr[t] = CSR(i64(c["in_indptr"]), i64(c["in_indices"]),
                        pos=i64(c["in_pos"]))
    return GraphStore(
        schema=schema,
        v_offset={t: int(v) for t, v in arrays["v_offset"].items()},
        v_count={t: int(v) for t, v in arrays["v_count"].items()},
        out_csr=out_csr, in_csr=in_csr,
        v_props={t: {k: i64(v) for k, v in p.items()}
                 for t, p in arrays["v_props"].items()},
        e_props={EdgeTriple(*key): {k: i64(v) for k, v in p.items()}
                 for key, p in arrays["e_props"].items()},
        str_vocab={k: dict(v) for k, v in arrays["str_vocab"].items()})
