"""zedx document-package preprocessing, the offline data prep (port of
``easyrag_tpu/corpus/zedx.py``).

Re-implements ``src/preprocess_zedx.py``: walk each package's
``nodetree.xml`` knowledge tree to map document URLs to knowledge paths,
convert the HTML docs to clean text, harvest figure captions/titles and
copy image dirs, and emit the ``format_data_with_img`` text tree plus
``pathmap.json`` / ``imgmap_raw.json``.

Behavioral notes mirrored from the reference:
* abbreviation ``<span class="xref gxref">`` glossary titles are expanded
  inline as ``word(en, cn)`` (:24-31)
* figures under ``figure.fig.fignone`` whose caption starts with 图 are
  recorded per output txt path (:34-67); the figure *title* is the caption
  text minus its span texts
* text cleanup drops consecutive duplicate lines and lines starting with
  "html", optionally prepends ``###\\n文档路径: <know path>`` (:96-119)
* HTML read as utf-8 with gb2312 fallback (:82-85)
"""

from __future__ import annotations

import json
import os
import shutil
import urllib.parse
from typing import Dict, Optional, Sequence, Tuple
from xml.etree import ElementTree

from .html_text import html_to_text

DEFAULT_PACKAGES = ("director", "emsplus", "rcp", "umac")


def walk_nodetree(node, parents: Tuple[str, ...], url2path: Dict[str, Tuple[str, ...]]):
    """DFS over nodetree.xml: url -> (package, section, ..., name)."""
    for child in node:
        sub_parents = parents + (child.get("name"),)
        url = (child.get("url") or "").replace("\\", "/")
        if url:
            url2path[url] = sub_parents
        walk_nodetree(child, sub_parents, url2path)


def _expand_abbreviations(soup) -> None:
    for span in soup.find_all("span", class_="xref gxref"):
        title = span.get("title")
        if title and span.string:
            parts = title.split("--")
            if len(parts) == 2:
                span.string = f"{span.string}({parts[0]}, {parts[1]})"
            else:
                span.string = f"{span.string}({title})"


def _harvest_figures(
    soup, package: str, url: str, meta_dir: str, build_dir: str, imgmap: Dict
) -> None:
    txt_path = os.path.join(
        package, url.replace(".html", ".txt").replace(".htm", ".txt")
    )
    for figure in soup.find_all("figure", class_="fig fig_ fignone"):
        cap_span = figure.find("span")
        figure_title = cap_span.string if cap_span else None
        if not figure_title or not figure_title.startswith("图"):
            continue
        figure_title = figure_title.strip()
        img = figure.find("img")
        if img is None or not img.get("src"):
            continue
        figure_path = urllib.parse.unquote(img["src"])
        dir_path = os.path.dirname(url)
        entry = imgmap.setdefault(txt_path, {})
        entry[figure_title] = {
            "img_path": os.path.join(package, dir_path, figure_path)
        }
        # figure *title*: caption text minus its nested span texts
        figcap = figure.find("figcaption")
        if figcap is not None:
            all_text = figcap.get_text(separator=" ", strip=True)
            for span in figcap.find_all("span"):
                all_text = all_text.replace(span.get_text(separator=" ", strip=True), "")
            entry[figure_title]["title"] = " ".join(all_text.split())
        else:
            entry[figure_title]["title"] = ""
        # copy the package's images directory alongside the text tree
        ori_img_dir = os.path.join(meta_dir, "documents", dir_path, "images")
        out_img_dir = os.path.join(build_dir, dir_path, "images")
        if os.path.exists(ori_img_dir) and not os.path.exists(out_img_dir):
            shutil.copytree(ori_img_dir, out_img_dir)


def clean_text(content: str, know_path: Sequence[str], with_path: bool = False) -> str:
    """Dedup consecutive lines, drop html-prefixed lines, optionally prepend
    the knowledge path header (:96-119)."""
    new_lines = []
    last_line: Optional[str] = None
    for line in content.split("\n"):
        if last_line == line:
            continue
        last_line = line
        line = line.strip()
        if line.startswith("html"):
            continue
        if line:
            new_lines.append(line)
    out = ""
    if with_path:
        out += "###\n文档路径: " + "/".join(know_path) + "\n\n"
    out += ("\n".join(new_lines) + "\n") if new_lines else "<文档为空>\n"
    return out


def _read_html(path: str) -> str:
    try:
        with open(path, "r", encoding="utf-8") as f:
            return f.read()
    except UnicodeDecodeError:
        with open(path, "r", encoding="gb2312", errors="replace") as f:
            return f.read()


def process_package(
    package: str,
    meta_root: str,
    out_root: str,
    pathmap: Dict,
    imgmap: Dict,
    with_path: bool = False,
) -> None:
    meta_dir = os.path.join(meta_root, package)
    build_dir = os.path.join(out_root, package)
    os.makedirs(build_dir, exist_ok=True)

    tree = ElementTree.fromstring(
        open(os.path.join(meta_dir, "nodetree.xml"), encoding="utf-8").read()
    )
    url2path: Dict[str, Tuple[str, ...]] = {}
    walk_nodetree(tree, (package,), url2path)

    from bs4 import BeautifulSoup

    for url, know_path in url2path.items():
        doc_path = os.path.join(meta_dir, "documents", url)
        if not os.path.exists(doc_path):
            continue
        if not (url.endswith(".html") or url.endswith(".htm")):
            continue
        soup = BeautifulSoup(_read_html(doc_path), "html.parser")
        _expand_abbreviations(soup)
        _harvest_figures(soup, package, url, meta_dir, build_dir, imgmap)
        text = html_to_text(str(soup))

        txt_url = url.replace(".html", ".txt").replace(".htm", ".txt")
        out_file = os.path.join(build_dir, txt_url)
        os.makedirs(os.path.dirname(out_file), exist_ok=True)
        pathmap["/".join([know_path[0], txt_url])] = list(know_path)
        with open(out_file, "w", encoding="utf-8") as f:
            f.write(clean_text(text, know_path, with_path=with_path))


def preprocess_zedx(
    meta_root: str,
    out_root: str,
    packages: Sequence[str] = DEFAULT_PACKAGES,
    with_path: bool = False,
) -> Tuple[Dict, Dict]:
    """Process all packages; write pathmap.json + imgmap_raw.json."""
    pathmap: Dict = {}
    imgmap: Dict = {}
    for package in packages:
        process_package(package, meta_root, out_root, pathmap, imgmap, with_path)
    os.makedirs(out_root, exist_ok=True)
    with open(os.path.join(out_root, "imgmap_raw.json"), "w", encoding="utf-8") as f:
        json.dump(imgmap, f, ensure_ascii=False, indent=4)
    with open(os.path.join(out_root, "pathmap.json"), "w", encoding="utf-8") as f:
        json.dump(pathmap, f, ensure_ascii=False, indent=4)
    return pathmap, imgmap


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--meta-root", default="../data/origin_data")
    parser.add_argument("--out-root", default="../data/format_data_with_img")
    parser.add_argument("--packages", nargs="*", default=list(DEFAULT_PACKAGES))
    parser.add_argument("--with_path", action="store_true", default=False)
    args = parser.parse_args()
    preprocess_zedx(args.meta_root, args.out_root, args.packages, args.with_path)
