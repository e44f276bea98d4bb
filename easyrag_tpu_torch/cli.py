"""Batch evaluation CLI (port of ``easyrag_tpu/cli.py``).

Replaces the reference's ``src/main.py``: run the pipeline over a test/val
split, save the answers and the submit file, compute the val split's keyword
accuracy, and dump the retrieval intermediates. The same flags, printed
lines and file layout as ``python -m easyrag_tpu.cli``, plus ``--device``
(the card unless the caller asks for the CPU; without a card it raises).

Usage:
    python -m easyrag_tpu_torch.cli --config configs/easyrag.yaml --split val \\
        [--re-only | --batch-answers] [--note best] [--no-save-inter] [--push] \\
        [--device cuda|cpu] [--set any_knob=value ...]

``--set key=value`` (repeatable) overrides any config knob, like fire's
keyword merge in the reference (``src/main.py:21-32``); dotted keys address
the tpu section (``--set tpu.query_batch=16``). The files land in the
working directory: ``outputs/submit_result_<split>_<note>.jsonl``,
``submit_result.jsonl`` and ``inter/<split>_<note>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List

from .config import load_config
from .eval import keyword_accuracy, read_jsonl, save_answers, write_jsonl
from .pipeline import EasyRAGPipeline
from .utils import run_sync


def get_test_data(split: str = "val", data_dir: str = "data") -> List[Dict[str, Any]]:
    """test -> ``question.jsonl``; anything else -> ``val.json``
    (``main.py:12-18``)."""
    if split == "test":
        return read_jsonl(os.path.join(data_dir, "question.jsonl"))
    with open(os.path.join(data_dir, "val.json"), encoding="utf-8") as f:
        return json.load(f)


async def run_batch(args: argparse.Namespace, **pipeline_kwargs) -> None:
    """The CLI's work for parsed ``args``. ``pipeline_kwargs`` go to
    ``EasyRAGPipeline`` beside the config and ``args.device`` (e.g. a
    ``sparse_tokenizer`` or ``splitter`` where jieba or the tiktoken table
    is missing)."""
    # like fire (src/main.py:21-32), only knobs the user actually passed
    # override the yaml; --re-only is sugar for --set re_only=true
    overrides: Dict[str, Any] = {}
    if args.re_only:
        overrides["re_only"] = True
    config = load_config(args.config, overrides=overrides, set_specs=args.set)
    args.re_only = config.re_only
    pipeline = EasyRAGPipeline(config, device=args.device, **pipeline_kwargs)
    queries = get_test_data(args.split, args.qa_dir)

    print("开始生成答案...")
    answers, all_nodes, all_contexts = [], [], []
    lat: List[float] = []
    t_all = time.perf_counter()
    batch_answers = getattr(args, "batch_answers", False)
    if args.re_only:
        # the whole query set in one call: retrieval runs it in 64-row batches
        t0 = time.perf_counter()
        results = await pipeline.run_retrieval_batch(queries)
        lat.append(time.perf_counter() - t0)
    elif batch_answers:
        # staged: one retrieval stream, the rerank per query, gen_batch-row
        # decodes, against the reference's sequential loop (src/main.py:48-52)
        t0 = time.perf_counter()
        results = await pipeline.run_answers_batch(queries)
        lat.append(time.perf_counter() - t0)
    else:
        results = []
        for query in queries:
            t0 = time.perf_counter()
            results.append(await pipeline.run(dict(query)))
            lat.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_all
    for res in results:
        answers.append(res["answer"])
        all_nodes.append(res["nodes"])
        all_contexts.append(res["contexts"])
    if queries:
        p50 = sorted(lat)[len(lat) // 2]
        print(
            f"吞吐: {len(queries) / wall:.2f} qps | "
            f"p50 {'batch' if args.re_only or batch_answers else 'query'}: {p50 * 1000:.1f} ms"
        )

    os.makedirs("outputs", exist_ok=True)
    answer_file = f"outputs/submit_result_{args.split}_{args.note}.jsonl"
    joined = save_answers(queries, answers, answer_file)
    print(f"保存结果至 {answer_file}")
    write_jsonl("submit_result.jsonl", joined)

    if args.split == "test" and args.push:
        from .submit import submit

        print(submit(joined))
    elif args.split == "val":
        acc = keyword_accuracy(joined, queries)
        print("average acc:", acc * 100)

    if args.save_inter:
        os.makedirs("inter", exist_ok=True)
        inter = []
        for query, answer, nodes, contexts in zip(queries, joined, all_nodes, all_contexts):
            row = {
                "id": query["id"],
                "query": query["query"],
                "answer": answer["answer"],
                "candidates": contexts,
                "paths": [n.metadata.get("file_path", "") for n in nodes],
                "know_paths": [n.metadata.get("know_path", "") for n in nodes],
                "quality": [0 for _ in contexts],
                "score": 0,
                "duplicate": 0,
            }
            if "keywords" in query:
                row["keywords"] = query["keywords"]
                row["gt"] = query["answer"]
            inter.append(row)
        inter_file = f"inter/{args.split}_{args.note}.json"
        with open(inter_file, "w", encoding="utf-8") as f:
            json.dump(inter, f, ensure_ascii=False, indent=4)
        print(f"保存中间结果至 {inter_file}")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="easyrag_tpu_torch batch evaluation")
    parser.add_argument("--config", default="configs/easyrag.yaml")
    parser.add_argument("--split", default="test", choices=["test", "val"])
    parser.add_argument("--re-only", action="store_true", dest="re_only")
    parser.add_argument("--push", action="store_true")
    parser.add_argument(
        "--batch-answers", action="store_true", dest="batch_answers",
        help="stage the whole split through batched retrieval -> rerank -> "
             "gen_batch-row decodes (pipeline.run_answers_batch) instead of "
             "the reference's sequential per-query loop (src/main.py:48-52); "
             "needs tpu.local_llm_answer",
    )
    parser.add_argument("--note", default="best")
    parser.add_argument("--qa-dir", default="data", help="dir with question.jsonl/val.json")
    parser.add_argument(
        "--set",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="override any config knob (fire-style, src/main.py:21-32); "
        "repeatable; dotted keys hit the tpu section (tpu.query_batch=16)",
    )
    parser.add_argument("--no-save-inter", action="store_false", dest="save_inter", default=True)
    parser.add_argument("--device", default="cuda", help="torch device of the models and indexes (cuda or cpu)")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    run_sync(run_batch(parse_args(argv)))


if __name__ == "__main__":
    main()
