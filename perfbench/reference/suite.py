"""One plain function per query of the CGP suite (``queries.json``).

Semantics, as the system states them: a pattern matches by homomorphism
(vertices and edges may repeat), a pattern edge without a label or with
several labels ranges over every schema triple that fits its endpoints'
types, an edge with no arrow matches either direction (each stored edge
once per direction it is read in), and ``count(x)`` counts matching rows.
Each function says the order in which it joins; none enumerates a
pattern in text order.  Every function takes the graph and the query's
parameters and returns an ``answers.Exact`` or ``answers.TopK``.
"""
from __future__ import annotations

import numpy as np

from perfbench.reference.answers import Exact, topk
from perfbench.reference.graph import Graph, gather

KNOWS = ("PERSON", "KNOWS", "PERSON")
LIKES_POST = ("PERSON", "LIKES", "POST")
LIKES_COMMENT = ("PERSON", "LIKES", "COMMENT")
HASINTEREST = ("PERSON", "HASINTEREST", "TAG")
PERSON_CITY = ("PERSON", "ISLOCATEDIN", "CITY")
WORKAT = ("PERSON", "WORKAT", "ORGANISATION")
POST_CREATOR = ("POST", "HASCREATOR", "PERSON")
COMMENT_CREATOR = ("COMMENT", "HASCREATOR", "PERSON")
REPLY_POST = ("COMMENT", "REPLYOF", "POST")
REPLY_COMMENT = ("COMMENT", "REPLYOF", "COMMENT")
POST_TAG = ("POST", "HASTAG", "TAG")
COMMENT_TAG = ("COMMENT", "HASTAG", "TAG")
CONTAINEROF = ("FORUM", "CONTAINEROF", "POST")
HASMEMBER = ("FORUM", "HASMEMBER", "PERSON")
HASMODERATOR = ("FORUM", "HASMODERATOR", "PERSON")
FORUM_TAG = ("FORUM", "HASTAG", "TAG")
HASTYPE = ("TAG", "HASTYPE", "TAGCLASS")
ORG_COUNTRY = ("ORGANISATION", "ISLOCATEDIN", "COUNTRY")


def _count(col: str, n) -> Exact:
    return Exact({col: np.array([int(n)], dtype=np.int64)})


def _wsum(idx: np.ndarray, weights: np.ndarray, n: int) -> np.ndarray:
    """Integer ``bincount`` of ``weights`` at ``idx``."""
    out = np.zeros(n, dtype=np.int64)
    np.add.at(out, idx, weights.astype(np.int64))
    return out


def _local(g: Graph, vtype: str, ids: np.ndarray) -> np.ndarray:
    return ids - g.offsets[vtype]


def qt1(g: Graph, p) -> Exact:
    """(p)<-[:HASCREATOR]-(m)<-[:CONTAINEROF]-(f): m can only be a POST.
    Over CONTAINEROF edges, times m's HASCREATOR out-degree."""
    _, m = g.edges(CONTAINEROF)
    return _count("COUNT(p)", g.out_degree(POST_CREATOR)[
        _local(g, "POST", m)].sum())


def qt2(g: Graph, p) -> Exact:
    """(p)-[]->(o:ORGANISATION)-[]->(c:COUNTRY): WORKAT edges into o,
    times o's ISLOCATEDIN out-degree."""
    _, o = g.edges(WORKAT)
    return _count("COUNT(p)", g.out_degree(ORG_COUNTRY)[
        _local(g, "ORGANISATION", o)].sum())


def qt3(g: Graph, p) -> Exact:
    """(p)<-[:ISLOCATEDIN]-(x)-[]->(t:TAG): x has an ISLOCATEDIN edge and
    an edge to a TAG only as a PERSON; per person, city degree times
    interest degree."""
    return _count("COUNT(p)", (g.out_degree(PERSON_CITY)
                               * g.out_degree(HASINTEREST)).sum())


def qt5(g: Graph, p) -> Exact:
    """(p1:POST)-[]->(p2), (p2)-[]->(c:CITY): p2 reaches a CITY only as a
    PERSON, so p1's edge is HASCREATOR; per creator edge, the creator's
    city degree."""
    _, p2 = g.edges(POST_CREATOR)
    return _count("COUNT(p2)", g.out_degree(PERSON_CITY)[
        _local(g, "PERSON", p2)].sum())


def _creator_interest(g: Graph) -> int:
    """Triangles message -HASCREATOR-> person -HASINTEREST-> tag <-HASTAG-
    message: HASTAG edges first, then each message's creators, then a
    probe of (creator, tag) in HASINTEREST."""
    total = 0
    for creator, tagged, mtype in ((POST_CREATOR, POST_TAG, "POST"),
                                   (COMMENT_CREATOR, COMMENT_TAG,
                                    "COMMENT")):
        m, tag = g.edges(tagged)
        rep, person = gather(*g.out[creator], _local(g, mtype, m))
        total += int(g.mult(HASINTEREST, person, tag[rep]).sum())
    return total


def qr1(g: Graph, p) -> Exact:
    """Qc1a's pattern (message:COMMENT|POST)-[:HASCREATOR]->(person),
    (message)-[:HASTAG]->(tag), (person)-[:HASINTEREST]->(tag)."""
    return _count("COUNT(person)", _creator_interest(g))


def qc1a(g: Graph, p) -> Exact:
    return _count("COUNT(person)", _creator_interest(g))


def _comment_person_tag(g: Graph, col: str) -> Exact:
    """(p:COMMENT)-[]->(p2:PERSON)-[]->(c:CITY), (p)<-[]-(message),
    (message)-[]->(tag:TAG).  Per comment p: (creator edges times the
    creator's city degree) times (the tag degree summed over what points
    at p: PERSON likes, with interests; COMMENT replies, with tags)."""
    n = g.counts["COMMENT"]
    c, p2 = g.edges(COMMENT_CREATOR)
    a = _wsum(_local(g, "COMMENT", c),
              g.out_degree(PERSON_CITY)[_local(g, "PERSON", p2)], n)
    m, c = g.edges(LIKES_COMMENT)
    b = _wsum(_local(g, "COMMENT", c),
              g.out_degree(HASINTEREST)[_local(g, "PERSON", m)], n)
    m, c = g.edges(REPLY_COMMENT)
    b += _wsum(_local(g, "COMMENT", c),
               g.out_degree(COMMENT_TAG)[_local(g, "COMMENT", m)], n)
    return _count(col, (a * b).sum())


def qr2(g: Graph, p) -> Exact:
    return _comment_person_tag(g, "COUNT(c)")


def qc3b(g: Graph, p) -> Exact:
    return _comment_person_tag(g, "COUNT(p)")


def qr3(g: Graph, p) -> Exact:
    """(author:PERSON)<-[:HASCREATOR]-(msg1:POST|COMMENT): the two
    HASCREATOR edge lists."""
    return _count("COUNT(author)", g.edges(POST_CREATOR)[0].shape[0]
                  + g.edges(COMMENT_CREATOR)[0].shape[0])


def qr4(g: Graph, p) -> Exact:
    """Qr3 with msg1.length > $len: HASCREATOR edges whose message is
    long enough."""
    n = 0
    for t, mtype in ((POST_CREATOR, "POST"), (COMMENT_CREATOR, "COMMENT")):
        m, _ = g.edges(t)
        n += int((g.vprop(mtype, "length", m) > p["len"]).sum())
    return _count("COUNT(author)", n)


def _knows_pairs(g: Graph, p) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The (p1, p2) pairs with p1.id = $id1 and p2.id = $id2, and how many
    KNOWS edges join each."""
    a = g.find("PERSON", "id", p["id1"])
    b = g.find("PERSON", "id", p["id2"])
    p1, p2 = np.repeat(a, b.shape[0]), np.tile(b, a.shape[0])
    return p1, p2, g.mult(KNOWS, p1, p2)


def qr5(g: Graph, p) -> Exact:
    """(p1:PERSON)-[:KNOWS]->(p2:PERSON) with both ids bound: the id
    lookups, then the edge multiplicity."""
    return _count("COUNT(p1)", _knows_pairs(g, p)[2].sum())


def qr6(g: Graph, p) -> Exact:
    """Qr5, then (p2)-[:LIKES]->(comment:COMMENT) with comment.length >
    $len: per pair, its KNOWS edges times p2's long liked comments."""
    _, p2, k = _knows_pairs(g, p)
    rep, c = g.nbrs(LIKES_COMMENT, "out", p2)
    long_ = g.vprop("COMMENT", "length", c) > p["len"]
    liked = np.bincount(rep[long_], minlength=p2.shape[0])
    return _count("COUNT(p1)", (k * liked).sum())


def qc1b(g: Graph, p) -> Exact:
    """(message:PERSON|FORUM)-[:KNOWS|HASMODERATOR]->(person:PERSON),
    (message)-[]->(tag:TAG), (person)-[]->(tag): for KNOWS, each edge with
    each of the source's interests, probing (person, tag) in HASINTEREST;
    for HASMODERATOR, the same with the forum's tags."""
    total = 0
    for t, tagged, mtype in ((KNOWS, HASINTEREST, "PERSON"),
                             (HASMODERATOR, FORUM_TAG, "FORUM")):
        m, person = g.edges(t)
        rep, tag = gather(*g.out[tagged], _local(g, mtype, m))
        total += int(g.mult(HASINTEREST, person[rep], tag).sum())
    return _count("COUNT(person)", total)


def qc2a(g: Graph, p) -> Exact:
    """(person1)-[:LIKES]->(message:POST|COMMENT)-[:HASCREATOR]->(person2),
    (person1)<-[:HASMODERATOR]-(place:FORUM), (person2)<-[:HASMODERATOR]-
    (place): LIKES edges, then the message's creators, then the forums
    moderating person1, probing (place, person2) in HASMODERATOR."""
    total = 0
    for likes, creator, mtype in ((LIKES_POST, POST_CREATOR, "POST"),
                                  (LIKES_COMMENT, COMMENT_CREATOR,
                                   "COMMENT")):
        p1, m = g.edges(likes)
        rep, p2 = gather(*g.out[creator], _local(g, mtype, m))
        p1 = p1[rep]
        rep, place = gather(*g.inn[HASMODERATOR], _local(g, "PERSON", p1))
        total += int(g.mult(HASMODERATOR, place, p2[rep]).sum())
    return _count("COUNT(person1)", total)


def qc4b(g: Graph, p) -> Exact:
    """(forum)-[:HASTAG]->(t:TAG), (forum)-[:HASMODERATOR]->(person1),
    (forum)-[:HASMODERATOR|CONTAINEROF]->(person2:PERSON|POST),
    (person1)-[:KNOWS|LIKES]->(person2), (person1)-[:HASINTEREST]->(t),
    (person2)-[:HASINTEREST|HASTAG]->(t): HASMODERATOR edges, then the
    forum's tags kept where person1 has that interest, then person2 over
    the forum's moderators (KNOWS, HASINTEREST) and its posts (LIKES,
    HASTAG), each probed."""
    forum, p1 = g.edges(HASMODERATOR)
    rep, t = gather(*g.out[FORUM_TAG], _local(g, "FORUM", forum))
    forum, p1 = forum[rep], p1[rep]
    w = g.mult(HASINTEREST, p1, t)
    keep = w > 0
    forum, p1, t, w = forum[keep], p1[keep], t[keep], w[keep]
    total = 0
    for via, link, tagged in ((HASMODERATOR, KNOWS, HASINTEREST),
                              (CONTAINEROF, LIKES_POST, POST_TAG)):
        rep, p2 = gather(*g.out[via], _local(g, "FORUM", forum))
        total += int((w[rep] * g.mult(link, p1[rep], p2)
                      * g.mult(tagged, p2, t[rep])).sum())
    return _count("COUNT(person1)", total)


def _person(g: Graph, p) -> np.ndarray:
    return g.find("PERSON", "id", p["pid"])


def ic1(g: Graph, p):
    """(p:PERSON)-[:KNOWS*2]-(friend:PERSON) with p.id = $pid: the
    2-walks over KNOWS in either direction, counted per endpoint; top 20
    by count."""
    _, x = g.und(KNOWS, _person(g, p))
    _, friend = g.und(KNOWS, x)
    c = np.bincount(friend, minlength=g.n_base)
    ids = np.nonzero(c)[0]
    return topk(("friend",), "c", [ids], c[ids], 20, True)


def _per_friend(g: Graph, p, weight: np.ndarray, col: str, k: int):
    """Top ``k`` friends (KNOWS either way from p) by the sum of
    ``weight[friend]`` over the edges reaching them."""
    _, friend = g.und(KNOWS, _person(g, p))
    c = np.bincount(friend, weights=weight[friend], minlength=g.n_base)
    c = np.rint(c).astype(np.int64)
    ids = np.nonzero(c)[0]
    return topk(("friend",), col, [ids], c[ids], k, True)


def _tagged_messages(g: Graph) -> np.ndarray:
    """Per vertex id: (message)-[:HASTAG]->(t) rows over the messages it
    created, (POST|COMMENT)-[:HASCREATOR]->(it)."""
    w = np.zeros(g.n_base, dtype=np.int64)
    for creator, tagged, mtype in ((POST_CREATOR, POST_TAG, "POST"),
                                   (COMMENT_CREATOR, COMMENT_TAG,
                                    "COMMENT")):
        m, person = g.edges(creator)
        np.add.at(w, person, g.out_degree(tagged)[_local(g, mtype, m)])
    return w


def ic3(g: Graph, p):
    """(p)-[:KNOWS]-(friend), (friend)<-[:HASCREATOR]-(m:POST|COMMENT),
    (m)-[:HASTAG]->(t): per friend, tagged messages (precomputed over all
    creators), times the KNOWS edges to p; top 20 by count(m)."""
    return _per_friend(g, p, _tagged_messages(g), "cnt", 20)


def ic11(g: Graph, p):
    """(p)-[:KNOWS]-(friend), (friend)-[:WORKAT]->(org),
    (org)-[:ISLOCATEDIN]->(c:COUNTRY): the friends, then their employers,
    weighted by the employer's country degree; grouped by (friend, org),
    lowest 10."""
    _, friend = g.und(KNOWS, _person(g, p))
    rep, org = g.nbrs(WORKAT, "out", friend)
    friend = friend[rep]
    n = g.out_degree(ORG_COUNTRY)[_local(g, "ORGANISATION", org)]
    key = friend * g.n_base + org
    uniq, inv = np.unique(key, return_inverse=True)
    tot = np.zeros(uniq.shape[0], dtype=np.int64)
    np.add.at(tot, inv, n)
    return topk(("friend", "org"), "n", [uniq // g.n_base, uniq % g.n_base],
                tot, 10, False)


def ic12(g: Graph, p):
    """(p)-[:KNOWS]-(friend), (friend)<-[:HASCREATOR]-(comment:COMMENT),
    (comment)-[:REPLYOF]->(post:POST), (post)-[:HASTAG]->(t),
    (t)-[:HASTYPE]->(tc): per comment, the tag-class paths of the posts
    it replies to; per person, summed over their comments; per friend,
    times the KNOWS edges to p; top 20."""
    tag_w = g.out_degree(HASTYPE)
    post_w = np.zeros(g.counts["POST"], dtype=np.int64)
    post, t = g.edges(POST_TAG)
    np.add.at(post_w, _local(g, "POST", post),
              tag_w[_local(g, "TAG", t)])
    comment, post = g.edges(REPLY_POST)
    com_w = np.zeros(g.counts["COMMENT"], dtype=np.int64)
    np.add.at(com_w, _local(g, "COMMENT", comment),
              post_w[_local(g, "POST", post)])
    w = np.zeros(g.n_base, dtype=np.int64)
    comment, person = g.edges(COMMENT_CREATOR)
    np.add.at(w, person, com_w[_local(g, "COMMENT", comment)])
    return _per_friend(g, p, w, "cnt", 20)


SUITE = {"Qt1": qt1, "Qt2": qt2, "Qt3": qt3, "Qt5": qt5, "Qr1": qr1,
         "Qr2": qr2, "Qr3": qr3, "Qr4": qr4, "Qr5": qr5, "Qr6": qr6,
         "Qc1a": qc1a, "Qc1b": qc1b, "Qc2a": qc2a, "Qc3b": qc3b,
         "Qc4b": qc4b, "ic1": ic1, "ic3": ic3, "ic11": ic11, "ic12": ic12}
