"""QA dataset IO and evaluation metrics (a copy of ``easyrag_tpu/eval.py``).

Mirrors ``src/easyrag/pipeline/qa.py`` (jsonl IO, answer joining) and the
val-split keyword-containment metric of ``src/main.py:74-91``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def write_jsonl(path: str, rows: Sequence[Dict[str, Any]]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for row in rows:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")


def save_answers(
    queries: Sequence[Dict[str, Any]],
    results: Sequence[str],
    path: str = "data/answers.jsonl",
) -> List[Dict[str, Any]]:
    """Join queries with generated answers and persist
    (``qa.py:18-28``)."""
    answers = [
        {"id": q["id"], "query": q["query"], "answer": r}
        for q, r in zip(queries, results)
    ]
    write_jsonl(path, answers)
    return answers


def keyword_accuracy(
    answers: Sequence[Dict[str, Any]], queries: Sequence[Dict[str, Any]]
) -> float:
    """Mean per-query fraction of gold keywords contained in the answer
    (``main.py:74-91``)."""
    if not queries:
        return 0.0
    total = 0.0
    for answer_obj, gt_obj in zip(answers, queries):
        answer = answer_obj["answer"]
        keywords = gt_obj["keywords"]
        hit = sum(1 for kw in keywords if kw in answer)
        total += hit / len(keywords)
    return total / len(queries)


def retrieval_recall(
    retrieved_paths: Sequence[Sequence[str]],
    gold_paths: Sequence[str],
    k: int,
) -> float:
    """Fraction of queries whose gold document path appears in the top-k
    retrieved paths — the recall@k gate of BASELINE.md (not present in the
    reference, which only evaluates end answers)."""
    if not gold_paths:
        return 0.0
    hits = sum(
        1 for paths, gold in zip(retrieved_paths, gold_paths) if gold in paths[:k]
    )
    return hits / len(gold_paths)
