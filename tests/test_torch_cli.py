"""``python -m easyrag_tpu_torch.cli`` beside ``python -m easyrag_tpu.cli`` on
one tiny corpus (``tests/test_cli.py``'s), on the CPU: the submit file, the
``submit_result.jsonl`` copy and the ``inter`` dump must be the same bytes,
and ``--set`` must reach the pipeline. The port's CLI runs in a subprocess
with ``jax``, ``jaxlib`` and ``easyrag_tpu`` blocked; with ``--batch-answers``
and in the per-query loop, both CLIs answer with their own generator over one
tiny saved Qwen2 checkpoint. Without ``--device`` the port's CLI takes the
card, and raises where there is none. Both sides chunk with the offline
token counter.
"""

import asyncio
import json
import os
import subprocess
import sys

import pytest
import torch

from easyrag_tpu import cli as jcli
from easyrag_tpu_torch import cli
from test_torch_decode import tiny_causal_checkpoint  # noqa: F401  (a fixture)
from test_torch_pipeline import offline_counter  # noqa: F401  (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("outputs/submit_result_val_t.jsonl", "submit_result.jsonl", "inter/val_t.json")

RUNNER = """
import sys
{block}
sys.path.insert(0, {repo!r})
from {pkg}.corpus import tokenizer
tokenizer._counter, tokenizer._counter_name = tokenizer.approx_token_count, "approx"
from {pkg}.cli import main
sys.argv = ["cli"] + {argv!r}
main()
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None and m.split(".")[0] in ("jax", "jaxlib", "easyrag_tpu"))
print("JAX_MODULES", loaded)
"""


def setup(tmp_path, extra=""):
    """The corpus, a config and a val split; returns ``(config, qa_dir)``."""
    corpus = tmp_path / "corpus"
    (corpus / "director").mkdir(parents=True)
    (corpus / "umac").mkdir()
    (corpus / "director" / "a.txt").write_text("扩容指南\nCDU虚机每次扩容的最大SC个数为15。\n", encoding="utf-8")
    (corpus / "director" / "b.txt").write_text("备份说明\n系统支持全量备份和增量备份。\n", encoding="utf-8")
    (corpus / "umac" / "c.txt").write_text("鉴权配置\n鉴权失败时检查LDAP连接。\n", encoding="utf-8")
    (corpus / "pathmap.json").write_text(json.dumps(
        {"director/a.txt": ["运维", "扩容"], "director/b.txt": ["运维", "备份"], "umac/c.txt": ["安全", "鉴权"]}),
        encoding="utf-8")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"retrieval_type: 2\nuse_reranker: 0\nchunk_size: 64\nchunk_overlap: 10\nf_topk_2: 4\n"
                   f"f_topk_3: 1\ndata_path: {corpus}\n{extra}tpu:\n  use_pallas: false\n", encoding="utf-8")
    qa = tmp_path / "qa"
    qa.mkdir()
    (qa / "val.json").write_text(json.dumps([
        {"id": 1, "query": "CDU扩容的最大SC个数？", "answer": "15", "keywords": ["15"], "document": ""},
        {"id": 2, "query": "鉴权失败怎么办", "answer": "LDAP", "keywords": ["LDAP"], "document": "umac"},
        {"id": 3, "query": "备份方式", "answer": "全量", "keywords": ["全量", "增量"]},
    ], ensure_ascii=False), encoding="utf-8")
    return str(cfg), str(qa)


def read(run_dir):
    return {name: open(os.path.join(run_dir, name), encoding="utf-8").read() for name in FILES}


def test_cli_matches_jax_cli_with_jax_blocked(tmp_path):
    cfg, qa = setup(tmp_path)
    argv = ["--config", cfg, "--split", "val", "--re-only", "--note", "t", "--qa-dir", qa,
            "--set", "f_topk_2=1", "--set", "f_topk_3=0", "--set", "tpu.query_batch=16"]
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": ""}
    env.pop("XLA_FLAGS", None)
    out = {}
    for pkg, extra, block in (("easyrag_tpu", [], ""),
                              ("easyrag_tpu_torch", ["--device", "cpu"],
                               'sys.modules["jax"] = sys.modules["jaxlib"] = sys.modules["easyrag_tpu"] = None')):
        run_dir = tmp_path / pkg
        run_dir.mkdir()
        script = RUNNER.format(block=block, repo=REPO, pkg=pkg, argv=argv + extra)
        proc = subprocess.run([sys.executable, "-c", script], cwd=str(run_dir), env=env, capture_output=True,
                              text=True, timeout=420)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "average acc" in proc.stdout and "吞吐:" in proc.stdout and "p50 batch" in proc.stdout
        out[pkg] = (read(str(run_dir)), proc.stdout)
    got, want = out["easyrag_tpu_torch"][0], out["easyrag_tpu"][0]
    assert got == want
    assert "JAX_MODULES []" in out["easyrag_tpu_torch"][1]
    inter = json.loads(got["inter/val_t.json"])
    assert inter[0]["paths"] == ["director/a.txt"] and "CDU" in inter[0]["candidates"][0]
    assert inter[1]["paths"] == ["umac/c.txt"]  # the document filter
    assert all(len(row["candidates"]) == 1 for row in inter)  # --set f_topk_2=1, f_topk_3=0
    rows = [json.loads(line) for line in got["submit_result.jsonl"].splitlines()]
    assert [r["id"] for r in rows] == [1, 2, 3] and all(r["answer"] == "" for r in rows)


@pytest.mark.parametrize("batch_answers", [False, True])
def test_cli_answers_match_jax_cli(tmp_path, monkeypatch, offline_counter, tiny_causal_checkpoint,  # noqa: F811
                                   batch_answers, capsys):
    extra = (f"local_llm_name: {tiny_causal_checkpoint}\ncache_path: {tmp_path / 'cache'}\n")
    cfg, qa = setup(tmp_path, extra)
    argv = ["--config", cfg, "--split", "val", "--note", "t", "--qa-dir", qa, "--set", "tpu.local_llm_answer=true",
            "--set", "tpu.local_llm_quant=", "--set", "tpu.local_llm_max_new=4", "--set", "tpu.local_llm_gen_batch=2"]
    if batch_answers:
        argv.append("--batch-answers")
    files = {}
    # the JAX CLI reads the same attributes of the parsed flags (and not --device)
    for name, run in (("jax", lambda: asyncio.run(jcli.run_batch(cli.parse_args(argv)))),
                      ("port", lambda: asyncio.run(cli.run_batch(cli.parse_args(argv + ["--device", "cpu"]))))):
        run_dir = tmp_path / name
        run_dir.mkdir()
        monkeypatch.chdir(run_dir)
        run()
        files[name] = read(str(run_dir))
        printed = capsys.readouterr().out
        assert ("p50 batch" if batch_answers else "p50 query") in printed and "average acc" in printed
    assert files["port"] == files["jax"]
    rows = [json.loads(line) for line in files["port"]["submit_result.jsonl"].splitlines()]
    assert all(r["answer"] for r in rows)


def test_cli_defaults_to_the_card(tmp_path, monkeypatch, offline_counter):  # noqa: F811
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    cfg, qa = setup(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert cli.parse_args(["--config", cfg]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", cfg, "--split", "val", "--re-only", "--qa-dir", qa])
