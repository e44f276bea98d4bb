"""The port's offline data prep (``easyrag_tpu_torch/corpus``: ``zedx``,
``html_text``, ``ocr``): the four cases of ``tests/test_zedx.py``, each also
held to the JAX package's output: the same text tree, ``pathmap.json`` and
``imgmap_raw.json`` byte for byte from one zedx package, the same text from
one HTML fragment, the same filtered image map."""

import filecmp
import json
import os

from easyrag_tpu.corpus import html_text as jhtml
from easyrag_tpu.corpus import ocr as jocr
from easyrag_tpu.corpus import zedx as jzedx
from easyrag_tpu_torch.corpus.html_text import html_to_text
from easyrag_tpu_torch.corpus.ocr import contains_chinese, filter_imgmap
from easyrag_tpu_torch.corpus.zedx import clean_text, preprocess_zedx
from test_zedx import _build_package


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, files in os.walk(root) for f in files)


def test_preprocess_zedx_end_to_end(tmp_path):
    meta_root, out_root = _build_package(tmp_path)
    pathmap, imgmap = preprocess_zedx(meta_root, out_root, packages=["director"])

    assert pathmap["director/guide/scale.txt"] == ["director", "运维指南", "扩容"]
    txt = open(os.path.join(out_root, "director", "guide", "scale.txt"), encoding="utf-8").read()
    assert "SC(Service Controller, 服务控制器)" in txt  # abbreviation expanded inline
    assert "| 虚机 | 最大个数 |" in txt and "| --- | --- |" in txt and "| CDU | 15 |" in txt
    assert "# 扩容指南" in txt
    fig = imgmap["director/guide/scale.txt"]["图1"]
    assert fig["img_path"] == os.path.join("director", "guide", "images/fig1 a.png")
    assert fig["title"] == "扩容组网示意"
    assert os.path.exists(os.path.join(out_root, "director", "guide", "images"))

    # the JAX package's prep of the same package: the same files, byte for byte
    ref_root = str(tmp_path / "out_jax")
    assert jzedx.preprocess_zedx(meta_root, ref_root, packages=["director"]) == (pathmap, imgmap)
    files = _tree(out_root)
    assert files == _tree(ref_root) and "pathmap.json" in files and "imgmap_raw.json" in files
    match, mismatch, errors = filecmp.cmpfiles(out_root, ref_root, files, shallow=False)
    assert mismatch == [] and errors == [] and len(match) == len(files)


def test_clean_text_rules():
    raw = "line1\nline1\n\nhtml junk\n  spaced  \n"
    out = clean_text(raw, ["pkg", "a"], with_path=True)
    assert out.startswith("###\n文档路径: pkg/a\n\n")
    assert out.count("line1") == 1
    assert "html junk" not in out and "spaced" in out
    assert clean_text("", ["p"], with_path=False) == "<文档为空>\n"
    for with_path in (True, False):
        assert clean_text(raw, ["pkg", "a"], with_path) == jzedx.clean_text(raw, ["pkg", "a"], with_path)


def test_html_to_text_lists_and_links():
    html = '<ul><li>第一项</li><li>第二项 <a href="x">链接文字</a></li></ul>'
    text = html_to_text(html)
    assert "* 第一项" in text and "* 第二项 链接文字" in text
    assert "href" not in text and "x" not in text.split("链接文字")[1]
    table = "<h2>标题</h2><p>段落 <b>粗体</b></p><table><tr><td>a</td><td>b</td></tr></table><pre> x\n y</pre>"
    for fragment in (html, table):
        assert html_to_text(fragment) == jhtml.html_to_text(fragment)


def test_ocr_filter_flow(tmp_path):
    imgmap = {
        "director/a.txt": {
            "图1": {"img_path": "director/one.png", "title": "t1"},
            "图2": {"img_path": "director/two.png", "title": "t2"},
            "图3": {"img_path": "director/three.png", "title": "t3", "content": "已有中文内容"},
        }
    }
    raw_path = tmp_path / "imgmap_raw.json"
    raw_path.write_text(json.dumps(imgmap), encoding="utf-8")

    def fake_ocr(path):
        return "中文文字" if "one" in path else "english only"

    def fake_caption(path):
        if "three" in path:
            raise RuntimeError("caption fail")  # kept without new content
        return f"描述:{os.path.basename(path)}"

    out = filter_imgmap(str(raw_path), str(tmp_path), out_path=str(tmp_path / "filtered.json"),
                        ocr_fn=fake_ocr, caption_fn=fake_caption)
    kept = out["director/a.txt"]
    assert set(kept) == {"图1", "图3"}  # 图2 dropped: no Chinese in its OCR text
    assert kept["图1"]["content"] == "描述:one.png"
    assert kept["图3"]["content"] == "已有中文内容"  # the caption failed: the original kept
    assert contains_chinese("中文") and not contains_chinese("abc")
    ref = jocr.filter_imgmap(str(raw_path), str(tmp_path), out_path=str(tmp_path / "filtered_jax.json"),
                             ocr_fn=fake_ocr, caption_fn=fake_caption)
    assert ref == out
    assert (tmp_path / "filtered.json").read_bytes() == (tmp_path / "filtered_jax.json").read_bytes()
