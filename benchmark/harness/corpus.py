"""The seeded corpus and the question mixes drawn from it.

The corpus is ``files`` one-chunk text files of ~``mean_words`` Zipf words
over a ``vocab``-word vocabulary, spread over product dirs, with a
``pathmap.json`` of know paths: the shape of the reference deployment's
product documentation at its scale. Questions are drawn from the files'
words by one general generator whose parameters come from a traffic file.
"""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class Corpus:
    root: str
    dirs: List[str]  # product dir of each doc
    texts: List[str]  # file content of each doc
    words: List[np.ndarray]  # word ids of each doc
    head: int  # words below this id are the Zipf head, as stopwords would drop

    def know_path(self, doc: int) -> str:
        return f"知识/{self.dirs[doc]}/doc{doc}"

    def rel_path(self, doc: int) -> str:
        return f"{self.dirs[doc]}/doc{doc}.txt"

    def file_path(self, doc: int) -> str:
        return os.path.join(self.root, self.rel_path(doc))


def make_corpus(root: str, seed: int, spec: Dict[str, Any]) -> Corpus:
    """Write the corpus under ``root`` (emptied first) from ``seed``."""
    rng = np.random.default_rng([seed, 1])
    n, vocab = spec["files"], spec["vocab"]
    zipf = 1.0 / np.arange(1, vocab + 1)
    zipf /= zipf.sum()
    lens = np.maximum(spec["min_words"], rng.poisson(spec["mean_words"], size=n))
    flat = rng.choice(vocab, size=int(lens.sum()), p=zipf)
    bounds = np.concatenate([[0], np.cumsum(lens)])
    names = spec["dirs"]
    shutil.rmtree(root, ignore_errors=True)
    for d in names:
        os.makedirs(os.path.join(root, d))
    corpus = Corpus(root=root, dirs=[names[f % len(names)] for f in range(n)], texts=[], words=[],
                    head=spec["head_words"])
    pathmap = {}
    for f in range(n):
        w = flat[bounds[f] : bounds[f + 1]]
        text = f"文档{f}\n" + " ".join(f"t{t}" for t in w.tolist()) + "\n"
        with open(corpus.file_path(f), "w", encoding="utf-8") as fh:
            fh.write(text)
        corpus.texts.append(text)
        corpus.words.append(w)
        pathmap[corpus.rel_path(f)] = corpus.know_path(f).split("/")
    with open(os.path.join(root, "pathmap.json"), "w", encoding="utf-8") as fh:
        json.dump(pathmap, fh)
    return corpus


def question_kind(i: int, mix: Dict[str, Any]) -> str:
    """``long``, ``filtered`` or ``plain``: the kind of question ``i`` of a mix."""
    if mix.get("long_every") and (i + 1) % mix["long_every"] == 0:
        return "long"
    if mix.get("filter_every") and (i + 1) % mix["filter_every"] == 0:
        return "filtered"
    return "plain"


def make_questions(corpus: Corpus, seed: int, mix: Dict[str, Any]) -> List[Dict[str, Any]]:
    """``mix["cycle"]`` questions, the same sizes for every seed in the same
    places: question ``i`` is long (``long_terms`` distinct words of eight
    random files, past the resident index's term budget) when ``i + 1`` is a
    multiple of ``long_every``, else dir-filtered (``document`` is the file's
    dir) when ``i + 1`` is a multiple of ``filter_every``, else plain.
    Plain and filtered questions are ``words`` distinct positions of one
    random file's words, the Zipf head left out; ``doc_name`` appends the
    file's name to a plain one, ``product`` puts its product dir in."""
    rng = np.random.default_rng([seed, 2])
    n = len(corpus.texts)

    def body(doc: int) -> List[str]:
        return [f"t{t}" for t in corpus.words[doc].tolist() if t >= corpus.head]

    out = []
    for i in range(mix["cycle"]):
        doc = int(rng.integers(0, n))
        kind = question_kind(i, mix)
        if kind == "long":
            pool: Dict[str, None] = {}
            for j in rng.integers(0, n, size=8):
                pool.update(dict.fromkeys(body(int(j))))
            q: Dict[str, Any] = {"query": " ".join(list(pool)[: mix["long_terms"]])}
        else:
            words = body(doc)
            picked = rng.choice(len(words), size=min(mix["words"], len(words)), replace=False)
            parts = [words[int(k)] for k in picked]
            filtered = kind == "filtered"
            if mix.get("doc_name") and not filtered:
                parts.append(f"doc{doc}")
            if mix.get("product"):
                parts.insert(int(rng.integers(0, len(parts) + 1)), corpus.dirs[doc])
            q = {"query": " ".join(parts)}
            if filtered:
                q["document"] = corpus.dirs[doc]
        out.append(q)
    return out


def dir_filter(question: Dict[str, Any]) -> Optional[str]:
    return question.get("document") or None
