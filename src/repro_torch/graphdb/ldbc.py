"""Deterministic synthetic LDBC-SNB-like data generator.

The paper evaluates on LDBC SNB graphs G30..G1000 (Table 1). The real
generator is out of scope here; this module produces graphs with the same
*schema*, power-law degree structure and correlated attributes, parameterized
by a scale factor, so every query in the paper's Appendix A runs and the
optimizer faces realistic skew. Deterministic per (sf, seed).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.schema import EdgeTriple, GraphSchema, ldbc_schema, motivating_schema
from repro_torch.graphdb.storage import GraphStore, build_store, encode_strings

_COUNTRY_NAMES = ["China", "India", "Germany", "France", "Brazil", "Japan",
                  "Mexico", "Egypt", "Spain", "Italy", "Kenya", "Peru"]
_TAG_NAMES = [f"tag_{i}" for i in range(200)]
_FIRST_NAMES = ["Jan", "Yang", "Maria", "Ahmed", "Li", "Anna", "Jose", "Ken"]


def _zipf_targets(rng: np.random.Generator, n_edges: int, n_targets: int,
                  a: float = 1.3) -> np.ndarray:
    """Skewed target sampling (power-law in-degree)."""
    if n_targets <= 0:
        return np.zeros(0, dtype=np.int64)
    ranks = rng.zipf(a, size=n_edges).astype(np.int64)
    return (ranks - 1) % n_targets


def _uniform(rng, n_edges, n) -> np.ndarray:
    return rng.integers(0, max(n, 1), size=n_edges, dtype=np.int64)


def generate_ldbc(sf: float = 1.0, seed: int = 7) -> GraphStore:
    """Scale factor 1.0 ~= 20k vertices / 140k edges; scales linearly."""
    rng = np.random.default_rng(seed)
    sch = ldbc_schema()
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
    E = EdgeTriple
    deg = {  # avg out-degree per triple (LDBC-ish ratios)
        E("PERSON", "KNOWS", "PERSON"): 18,
        E("PERSON", "LIKES", "POST"): 12,
        E("PERSON", "LIKES", "COMMENT"): 9,
        E("PERSON", "HASINTEREST", "TAG"): 5,
        E("PERSON", "ISLOCATEDIN", "CITY"): 1,
        E("PERSON", "WORKAT", "ORGANISATION"): 1,
        E("POST", "HASCREATOR", "PERSON"): 1,
        E("COMMENT", "HASCREATOR", "PERSON"): 1,
        E("COMMENT", "REPLYOF", "POST"): 1,
        E("COMMENT", "REPLYOF", "COMMENT"): 1,
        E("POST", "HASTAG", "TAG"): 2,
        E("COMMENT", "HASTAG", "TAG"): 1,
        E("FORUM", "CONTAINEROF", "POST"): 6,
        E("FORUM", "HASMEMBER", "PERSON"): 30,
        E("FORUM", "HASMODERATOR", "PERSON"): 1,
        E("FORUM", "HASTAG", "TAG"): 2,
        E("TAG", "HASTYPE", "TAGCLASS"): 1,
        E("CITY", "ISPARTOF", "COUNTRY"): 1,
        E("ORGANISATION", "ISLOCATEDIN", "COUNTRY"): 1,
    }
    edges: dict[EdgeTriple, tuple[np.ndarray, np.ndarray]] = {}
    for t, d in deg.items():
        ns, nd = n[t.src], n[t.dst]
        if d == 1:
            src = np.arange(ns, dtype=np.int64)
            if t.label in ("ISPARTOF", "HASTYPE", "ISLOCATEDIN"):
                dst = _uniform(rng, ns, nd)
            else:
                dst = _zipf_targets(rng, ns, nd)
        else:
            m = ns * d
            src = rng.integers(0, ns, size=m, dtype=np.int64)
            dst = _zipf_targets(rng, m, nd)
        if t.src == t.dst:
            keep = src != dst
            src, dst = src[keep], dst[keep]
        edges[t] = (src, dst)

    vocab: dict[str, dict[str, int]] = {"name": {}, "firstName": {}}
    dates = lambda k: rng.integers(1_262_304_000, 1_356_998_400, size=k)
    v_props = {
        "PERSON": {
            "id": np.arange(n["PERSON"], dtype=np.int64),
            "firstName": encode_strings(
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
                "name": encode_strings(_TAG_NAMES[:n["TAG"]], vocab["name"])},
        "TAGCLASS": {"id": np.arange(n["TAGCLASS"], dtype=np.int64),
                     "name": encode_strings(
                         [f"class_{i}" for i in range(n["TAGCLASS"])],
                         vocab["name"])},
        "CITY": {"id": np.arange(n["CITY"], dtype=np.int64),
                 "name": encode_strings(
                     [f"city_{i}" for i in range(n["CITY"])], vocab["name"])},
        "COUNTRY": {"id": np.arange(n["COUNTRY"], dtype=np.int64),
                    "name": encode_strings(
                        _COUNTRY_NAMES[:n["COUNTRY"]], vocab["name"])},
        "ORGANISATION": {"id": np.arange(n["ORGANISATION"], dtype=np.int64),
                         "name": encode_strings(
                             [f"org_{i}" for i in range(n["ORGANISATION"])],
                             vocab["name"])},
    }
    e_props = {E("PERSON", "KNOWS", "PERSON"):
               {"creationDate": dates(len(edges[E("PERSON", "KNOWS", "PERSON")][0]))}}
    return build_store(sch, n, edges, v_props, e_props, vocab)


# --------------------------------------------------------------------------
# Streamed generation (sharded-backend scale sweeps)
# --------------------------------------------------------------------------

# fixed source-range unit of the streamed generator: every (triple, chunk)
# and (vertex type, chunk) draws from its own SeedSequence-derived RNG, so
# the dataset is a pure function of (sf, seed) — independent of how many
# chunks a consumer materializes at once or which shard generates which
# range.  generate_ldbc consumes ONE sequential rng, which makes its output
# depend on generation order; the streamed layout trades stream identity
# (different data for the same seed) for order-free determinism.
_STREAM_CHUNK = 4096


def _stream_chunks(seed: int, tag: tuple, total: int, fn):
    """Concatenate ``fn(rng, lo, hi)`` over fixed ``_STREAM_CHUNK`` source
    ranges, each with an independent ``SeedSequence((seed, *tag, chunk))``
    RNG.  Peak working memory is one chunk's output."""
    parts = []
    key = [seed] + [hash(t) & 0x7FFFFFFF if isinstance(t, str) else t
                    for t in tag]
    for ci, lo in enumerate(range(0, max(total, 0), _STREAM_CHUNK)):
        hi = min(lo + _STREAM_CHUNK, total)
        rng = np.random.default_rng(np.random.SeedSequence(key + [ci]))
        parts.append(fn(rng, lo, hi))
    if not parts:
        return np.zeros(0, dtype=np.int64)
    # 1-D chunks stack end-to-end; (k, m) chunks (e.g. src/dst pairs)
    # stack along their last axis
    return np.concatenate(parts, axis=parts[0].ndim - 1)


def generate_ldbc_streamed(sf: float = 1.0, seed: int = 7) -> GraphStore:
    """``generate_ldbc``'s schema and skew, generated streamed: edges and
    properties materialize in fixed per-source-range chunks with
    independent seeded RNGs (see ``_STREAM_CHUNK``), so scale factors
    beyond a single generation buffer stream through bounded memory and
    any shard can regenerate exactly its own ranges.  Deterministic per
    ``(sf, seed)``; **not** stream-identical to ``generate_ldbc``."""
    sch = ldbc_schema()
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
    E = EdgeTriple
    deg = {
        E("PERSON", "KNOWS", "PERSON"): 18,
        E("PERSON", "LIKES", "POST"): 12,
        E("PERSON", "LIKES", "COMMENT"): 9,
        E("PERSON", "HASINTEREST", "TAG"): 5,
        E("PERSON", "ISLOCATEDIN", "CITY"): 1,
        E("PERSON", "WORKAT", "ORGANISATION"): 1,
        E("POST", "HASCREATOR", "PERSON"): 1,
        E("COMMENT", "HASCREATOR", "PERSON"): 1,
        E("COMMENT", "REPLYOF", "POST"): 1,
        E("COMMENT", "REPLYOF", "COMMENT"): 1,
        E("POST", "HASTAG", "TAG"): 2,
        E("COMMENT", "HASTAG", "TAG"): 1,
        E("FORUM", "CONTAINEROF", "POST"): 6,
        E("FORUM", "HASMEMBER", "PERSON"): 30,
        E("FORUM", "HASMODERATOR", "PERSON"): 1,
        E("FORUM", "HASTAG", "TAG"): 2,
        E("TAG", "HASTYPE", "TAGCLASS"): 1,
        E("CITY", "ISPARTOF", "COUNTRY"): 1,
        E("ORGANISATION", "ISLOCATEDIN", "COUNTRY"): 1,
    }
    uniform_labels = ("ISPARTOF", "HASTYPE", "ISLOCATEDIN")
    edges: dict[EdgeTriple, tuple[np.ndarray, np.ndarray]] = {}
    for ti, (t, d) in enumerate(sorted(deg.items(),
                                       key=lambda kv: repr(kv[0]))):
        ns, nd = n[t.src], n[t.dst]
        if d == 1:
            src = np.arange(ns, dtype=np.int64)
            if t.label in uniform_labels:
                dst = _stream_chunks(seed, ("e", ti), ns,
                                     lambda r, lo, hi: _uniform(r, hi - lo,
                                                                nd))
            else:
                dst = _stream_chunks(seed, ("e", ti), ns,
                                     lambda r, lo, hi: _zipf_targets(
                                         r, hi - lo, nd))
        else:
            def mk(r, lo, hi, _d=d, _nd=nd):
                m = (hi - lo) * _d
                s = r.integers(lo, hi, size=m, dtype=np.int64)
                return np.stack([s, _zipf_targets(r, m, _nd)])
            both = _stream_chunks(seed, ("e", ti), ns, mk)
            if both.ndim == 1:                      # ns == 0: no chunks
                both = both.reshape(2, 0)
            src, dst = both[0], both[1]
        if t.src == t.dst:
            keep = src != dst
            src, dst = src[keep], dst[keep]
        edges[t] = (src, dst)

    vocab: dict[str, dict[str, int]] = {"name": {}, "firstName": {}}

    def dates(ty, k):
        return _stream_chunks(seed, ("d", ty), k,
                              lambda r, lo, hi: r.integers(
                                  1_262_304_000, 1_356_998_400,
                                  size=hi - lo))

    def first_names(k):
        idx = _stream_chunks(seed, ("fn",), k,
                             lambda r, lo, hi: r.integers(
                                 0, len(_FIRST_NAMES), hi - lo))
        return encode_strings([_FIRST_NAMES[i % len(_FIRST_NAMES)]
                               for i in idx], vocab["firstName"])

    def lengths(ty, k):
        return _stream_chunks(seed, ("len", ty), k,
                              lambda r, lo, hi: r.integers(
                                  0, 256, size=hi - lo).astype(np.int64))

    v_props = {
        "PERSON": {"id": np.arange(n["PERSON"], dtype=np.int64),
                   "firstName": first_names(n["PERSON"]),
                   "creationDate": dates("PERSON", n["PERSON"])},
        "POST": {"id": np.arange(n["POST"], dtype=np.int64),
                 "length": lengths("POST", n["POST"]),
                 "creationDate": dates("POST", n["POST"])},
        "COMMENT": {"id": np.arange(n["COMMENT"], dtype=np.int64),
                    "length": lengths("COMMENT", n["COMMENT"]),
                    "creationDate": dates("COMMENT", n["COMMENT"])},
        "FORUM": {"id": np.arange(n["FORUM"], dtype=np.int64),
                  "creationDate": dates("FORUM", n["FORUM"])},
        "TAG": {"id": np.arange(n["TAG"], dtype=np.int64),
                "name": encode_strings(_TAG_NAMES[:n["TAG"]], vocab["name"])},
        "TAGCLASS": {"id": np.arange(n["TAGCLASS"], dtype=np.int64),
                     "name": encode_strings(
                         [f"class_{i}" for i in range(n["TAGCLASS"])],
                         vocab["name"])},
        "CITY": {"id": np.arange(n["CITY"], dtype=np.int64),
                 "name": encode_strings(
                     [f"city_{i}" for i in range(n["CITY"])], vocab["name"])},
        "COUNTRY": {"id": np.arange(n["COUNTRY"], dtype=np.int64),
                    "name": encode_strings(
                        _COUNTRY_NAMES[:n["COUNTRY"]], vocab["name"])},
        "ORGANISATION": {"id": np.arange(n["ORGANISATION"], dtype=np.int64),
                         "name": encode_strings(
                             [f"org_{i}" for i in range(n["ORGANISATION"])],
                             vocab["name"])},
    }
    knows = E("PERSON", "KNOWS", "PERSON")
    e_props = {knows: {"creationDate": dates("E_KNOWS",
                                             len(edges[knows][0]))}}
    return build_store(sch, n, edges, v_props, e_props, vocab)


def generate_motivating(n_person=300, n_product=120, n_place=30,
                        seed: int = 3) -> GraphStore:
    """Small Fig.1 graph for unit tests and the quickstart example."""
    rng = np.random.default_rng(seed)
    sch = motivating_schema()
    E = EdgeTriple
    n = {"PERSON": n_person, "PRODUCT": n_product, "PLACE": n_place}
    mk = lambda ns, nd, d: (rng.integers(0, ns, ns * d),
                            _zipf_targets(rng, ns * d, nd))
    edges = {
        E("PERSON", "KNOWS", "PERSON"): mk(n_person, n_person, 6),
        E("PERSON", "PURCHASES", "PRODUCT"): mk(n_person, n_product, 4),
        E("PERSON", "LOCATEDIN", "PLACE"): (np.arange(n_person),
                                            _uniform(rng, n_person, n_place)),
        E("PRODUCT", "PRODUCEDIN", "PLACE"): (np.arange(n_product),
                                              _uniform(rng, n_product, n_place)),
    }
    s, d = edges[E("PERSON", "KNOWS", "PERSON")]
    keep = s != d
    edges[E("PERSON", "KNOWS", "PERSON")] = (s[keep], d[keep])
    vocab = {"name": {}}
    v_props = {
        "PERSON": {"id": np.arange(n_person, dtype=np.int64),
                   "name": encode_strings([f"p{i}" for i in range(n_person)],
                                          vocab["name"])},
        "PRODUCT": {"id": np.arange(n_product, dtype=np.int64),
                    "name": encode_strings([f"prod{i}" for i in range(n_product)],
                                           vocab["name"])},
        "PLACE": {"id": np.arange(n_place, dtype=np.int64),
                  "name": encode_strings(
                      (_COUNTRY_NAMES * ((n_place // len(_COUNTRY_NAMES)) + 1)
                       )[:n_place], vocab["name"])},
    }
    return build_store(sch, n, edges, v_props, None, vocab)
