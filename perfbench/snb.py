"""Frozen copy of the repo's LDBC-SNB-like generator, returning raw arrays.

A copy of ``generate_ldbc`` and ``_zipf_targets`` (``repro_torch.graphdb.
ldbc``) as they stood when the benchmark was defined, so a later change to
the port cannot move the data it is measured on.  The generator draws from
one sequential ``numpy`` generator in the same order as the original, so a
seed gives the same graph.  It returns the arrays ``build_store`` takes;
the benchmark hands the same arrays to the port and to the reference.

Vertex ids: type ``t`` owns ``[offset[t], offset[t] + count[t])`` in the
schema's vertex-type order (``VERTEX_TYPES``), as in the port's store.
"""
from __future__ import annotations

import dataclasses

import numpy as np

VERTEX_TYPES = ("PERSON", "POST", "COMMENT", "FORUM", "TAG", "TAGCLASS",
                "CITY", "COUNTRY", "ORGANISATION")

# (src type, label, dst type) -> average out-degree (LDBC-ish ratios)
DEGREES = {
    ("PERSON", "KNOWS", "PERSON"): 18,
    ("PERSON", "LIKES", "POST"): 12,
    ("PERSON", "LIKES", "COMMENT"): 9,
    ("PERSON", "HASINTEREST", "TAG"): 5,
    ("PERSON", "ISLOCATEDIN", "CITY"): 1,
    ("PERSON", "WORKAT", "ORGANISATION"): 1,
    ("POST", "HASCREATOR", "PERSON"): 1,
    ("COMMENT", "HASCREATOR", "PERSON"): 1,
    ("COMMENT", "REPLYOF", "POST"): 1,
    ("COMMENT", "REPLYOF", "COMMENT"): 1,
    ("POST", "HASTAG", "TAG"): 2,
    ("COMMENT", "HASTAG", "TAG"): 1,
    ("FORUM", "CONTAINEROF", "POST"): 6,
    ("FORUM", "HASMEMBER", "PERSON"): 30,
    ("FORUM", "HASMODERATOR", "PERSON"): 1,
    ("FORUM", "HASTAG", "TAG"): 2,
    ("TAG", "HASTYPE", "TAGCLASS"): 1,
    ("CITY", "ISPARTOF", "COUNTRY"): 1,
    ("ORGANISATION", "ISLOCATEDIN", "COUNTRY"): 1,
}
TRIPLES = tuple(DEGREES)

_COUNTRY_NAMES = ["China", "India", "Germany", "France", "Brazil", "Japan",
                  "Mexico", "Egypt", "Spain", "Italy", "Kenya", "Peru"]
_TAG_NAMES = [f"tag_{i}" for i in range(200)]
_FIRST_NAMES = ["Jan", "Yang", "Maria", "Ahmed", "Li", "Anna", "Jose", "Ken"]


def zipf_targets(rng: np.random.Generator, n_edges: int, n_targets: int,
                 a: float = 1.3) -> np.ndarray:
    """Skewed target sampling (power-law in-degree)."""
    if n_targets <= 0:
        return np.zeros(0, dtype=np.int64)
    ranks = rng.zipf(a, size=n_edges).astype(np.int64)
    return (ranks - 1) % n_targets


def _uniform(rng, n_edges, n) -> np.ndarray:
    return rng.integers(0, max(n, 1), size=n_edges, dtype=np.int64)


def _encode_strings(values: list[str], vocab: dict[str, int]) -> np.ndarray:
    out = np.empty(len(values), dtype=np.int64)
    for i, v in enumerate(values):
        if v not in vocab:
            vocab[v] = len(vocab)
        out[i] = vocab[v]
    return out


@dataclasses.dataclass
class RawGraph:
    """What ``build_store`` takes: vertex counts, per-triple local
    ``(src, dst)`` edge lists (duplicates kept), properties, string
    vocabularies."""
    counts: dict[str, int]
    edges: dict[tuple, tuple[np.ndarray, np.ndarray]]
    v_props: dict[str, dict[str, np.ndarray]]
    e_props: dict[tuple, dict[str, np.ndarray]]
    vocab: dict[str, dict[str, int]]

    @property
    def offsets(self) -> dict[str, int]:
        out, off = {}, 0
        for t in VERTEX_TYPES:
            out[t] = off
            off += self.counts[t]
        return out

    @property
    def n_vertices(self) -> int:
        return sum(self.counts.values())


def generate(sf: float, seed: int) -> RawGraph:
    """Scale factor 1.0 ~= 20k vertices / 140k edges; scales linearly."""
    rng = np.random.default_rng(seed)
    n = {
        "PERSON": int(1800 * sf),
        "POST": int(5200 * sf),
        "COMMENT": int(8600 * sf),
        "FORUM": int(900 * sf),
        "TAG": 200,
        "TAGCLASS": 20,
        "CITY": 60,
        "COUNTRY": 12,
        "ORGANISATION": int(200 * max(sf, 0.25)),
    }
    edges: dict[tuple, tuple[np.ndarray, np.ndarray]] = {}
    for t, d in DEGREES.items():
        src_t, label, dst_t = t
        ns, nd = n[src_t], n[dst_t]
        if d == 1:
            src = np.arange(ns, dtype=np.int64)
            if label in ("ISPARTOF", "HASTYPE", "ISLOCATEDIN"):
                dst = _uniform(rng, ns, nd)
            else:
                dst = zipf_targets(rng, ns, nd)
        else:
            m = ns * d
            src = rng.integers(0, ns, size=m, dtype=np.int64)
            dst = zipf_targets(rng, m, nd)
        if src_t == dst_t:
            keep = src != dst
            src, dst = src[keep], dst[keep]
        edges[t] = (src, dst)

    vocab: dict[str, dict[str, int]] = {"name": {}, "firstName": {}}

    def dates(k):
        return rng.integers(1_262_304_000, 1_356_998_400, size=k)

    v_props = {
        "PERSON": {
            "id": np.arange(n["PERSON"], dtype=np.int64),
            "firstName": _encode_strings(
                [_FIRST_NAMES[i % len(_FIRST_NAMES)]
                 for i in rng.integers(0, len(_FIRST_NAMES), n["PERSON"])],
                vocab["firstName"]),
            "creationDate": dates(n["PERSON"]),
        },
        "POST": {
            "id": np.arange(n["POST"], dtype=np.int64),
            "length": rng.integers(0, 256, size=n["POST"]).astype(np.int64),
            "creationDate": dates(n["POST"]),
        },
        "COMMENT": {
            "id": np.arange(n["COMMENT"], dtype=np.int64),
            "length": rng.integers(0, 256, size=n["COMMENT"]).astype(np.int64),
            "creationDate": dates(n["COMMENT"]),
        },
        "FORUM": {"id": np.arange(n["FORUM"], dtype=np.int64),
                  "creationDate": dates(n["FORUM"])},
        "TAG": {"id": np.arange(n["TAG"], dtype=np.int64),
                "name": _encode_strings(_TAG_NAMES[:n["TAG"]],
                                        vocab["name"])},
        "TAGCLASS": {"id": np.arange(n["TAGCLASS"], dtype=np.int64),
                     "name": _encode_strings(
                         [f"class_{i}" for i in range(n["TAGCLASS"])],
                         vocab["name"])},
        "CITY": {"id": np.arange(n["CITY"], dtype=np.int64),
                 "name": _encode_strings(
                     [f"city_{i}" for i in range(n["CITY"])], vocab["name"])},
        "COUNTRY": {"id": np.arange(n["COUNTRY"], dtype=np.int64),
                    "name": _encode_strings(
                        _COUNTRY_NAMES[:n["COUNTRY"]], vocab["name"])},
        "ORGANISATION": {"id": np.arange(n["ORGANISATION"], dtype=np.int64),
                         "name": _encode_strings(
                             [f"org_{i}" for i in range(n["ORGANISATION"])],
                             vocab["name"])},
    }
    knows = ("PERSON", "KNOWS", "PERSON")
    e_props = {knows: {"creationDate": dates(len(edges[knows][0]))}}
    return RawGraph(n, edges, v_props, e_props, vocab)


def dedupe(src: np.ndarray, dst: np.ndarray, n_dst: int) -> np.ndarray:
    """The distinct ``(src, dst)`` pairs of an edge list as sorted keys
    ``src * n_dst + dst``: a store keeps each edge once."""
    return np.unique(src.astype(np.int64) * n_dst + dst)
