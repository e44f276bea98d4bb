"""The corpus and the question mixes repeat for a seed."""

from __future__ import annotations

import os

from benchmark.harness.corpus import make_corpus, make_questions, question_kind
from benchmark.tests.conftest import BATCH, QUERY, SEED


def test_corpus_and_questions_repeat(tmp_path, tiny_cell):
    cell = tiny_cell(QUERY)
    a = make_corpus(str(tmp_path / "a"), SEED, cell.config["corpus"])
    b = make_corpus(str(tmp_path / "b"), SEED, cell.config["corpus"])
    c = make_corpus(str(tmp_path / "c"), SEED + 1, cell.config["corpus"])
    assert a.texts == b.texts and a.dirs == b.dirs and a.texts != c.texts
    with open(a.file_path(7), encoding="utf-8") as f:
        assert f.read() == a.texts[7]
    assert os.path.isfile(os.path.join(a.root, "pathmap.json"))
    qa, qb = make_questions(a, SEED, cell.traffic), make_questions(b, SEED, cell.traffic)
    qc = make_questions(c, SEED + 1, cell.traffic)
    assert qa == qb and qa != qc and len(qa) == cell.traffic["cycle"]


def test_every_seed_sends_the_same_sizes(tmp_path, tiny_cell):
    cell = tiny_cell(BATCH)
    corpus = make_corpus(str(tmp_path / "a"), SEED, cell.config["corpus"])
    mix = cell.traffic
    for seed in (1, SEED):
        qs = make_questions(corpus, seed, mix)
        for i, q in enumerate(qs):
            kind = question_kind(i, mix)
            n = len(q["query"].split())
            if kind == "long":
                assert n == mix["long_terms"] and len(set(q["query"].split())) == n and "document" not in q
            elif kind == "filtered":
                assert n == mix["words"] and q["document"] in corpus.dirs
            else:
                assert n == mix["words"] + 1 and q["query"].split()[-1].startswith("doc")
