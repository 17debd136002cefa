"""MQ2007 learning-to-rank (reference: python/paddle/dataset/mq2007.py —
LETOR 4.0 query-document features with relevance judgments).

File format (reference Query.__init__ docstring):
    <rel> qid:<qid> 1:<v> 2:<v> ... 46:<v> #docid = ...
Readers mirror the reference's three modes:
    pointwise: (score, feature[46])
    pairwise:  (label, left_feature, right_feature) for rel_l > rel_r
    listwise:  (score_list, feature_matrix) per query

Real path: <DATA_HOME>/MQ2007/{train,test}.txt; otherwise deterministic
synthetic queries.
"""
import os

import numpy as np

from . import common

__all__ = ["train", "test", "Query", "QueryList"]

FEATURE_DIM = 46


class Query(object):
    """One judged query-document row (reference mq2007.py Query:50)."""

    def __init__(self, query_id=-1, relevance_score=-1, feature_vector=None,
                 description=""):
        self.query_id = query_id
        self.relevance_score = relevance_score
        self.feature_vector = feature_vector or []
        self.description = description

    @classmethod
    def parse(cls, line):
        head, _, desc = line.partition("#")
        parts = head.split()
        if len(parts) < 2 or not parts[1].startswith("qid:"):
            return None
        rel = int(parts[0])
        qid = int(parts[1].split(":")[1])
        feats = [0.0] * FEATURE_DIM
        for kv in parts[2:]:
            k, _, v = kv.partition(":")
            try:
                idx = int(k) - 1
            except ValueError:
                continue
            if 0 <= idx < FEATURE_DIM:
                feats[idx] = float(v)
        return cls(qid, rel, feats, desc.strip())


class QueryList(object):
    """All judged documents of one query (reference QueryList:106)."""

    def __init__(self, querylist=None):
        self.query_list = querylist or []

    def append(self, q):
        self.query_list.append(q)

    def __iter__(self):
        return iter(self.query_list)

    def __len__(self):
        return len(self.query_list)

    def _correct_ranking_(self):
        self.query_list.sort(key=lambda q: -q.relevance_score)


def _groups(split, n_queries=24):
    path = os.path.join(common.cache_path("MQ2007"), "%s.txt" % split)
    if os.path.exists(path):
        def gen():
            current, qid = QueryList(), None
            with open(path, errors="ignore") as f:
                for line in f:
                    q = Query.parse(line.strip())
                    if q is None:
                        continue
                    if qid is not None and q.query_id != qid and len(current):
                        yield current
                        current = QueryList()
                    qid = q.query_id
                    current.append(q)
            if len(current):
                yield current
        return gen
    common.synthetic_note("mq2007")
    rng = common.rng_for("mq2007", split)

    def gen():
        for qid in range(n_queries):
            ql = QueryList()
            for _ in range(rng.randint(4, 12)):
                feats = rng.rand(FEATURE_DIM).astype("float64").tolist()
                rel = int(min(2, feats[0] * 3))   # learnable signal
                ql.append(Query(qid, rel, feats))
            yield ql
    return gen


def _reader(split, format):
    def pointwise():
        for ql in _groups(split)():
            for q in ql:
                yield q.relevance_score, np.array(q.feature_vector)

    def pairwise():
        for ql in _groups(split)():
            ql._correct_ranking_()
            docs = list(ql)
            for i, left in enumerate(docs):
                for right in docs[i + 1:]:
                    if left.relevance_score > right.relevance_score:
                        yield (np.array([1.0]), np.array(left.feature_vector),
                               np.array(right.feature_vector))

    def listwise():
        for ql in _groups(split)():
            yield (np.array([q.relevance_score for q in ql]),
                   np.array([q.feature_vector for q in ql]))

    return {"pointwise": pointwise, "pairwise": pairwise,
            "listwise": listwise}[format]


def train(format="pairwise"):
    return _reader("train", format)


def test(format="pairwise"):
    return _reader("test", format)
