"""Corpus reader: recursive ``.txt`` ingestion.

Replaces ``SimpleDirectoryReader(input_dir, recursive=True,
required_exts=[".txt"])`` as used at ``src/easyrag/pipeline/ingestion.py:79-87``.
Each file becomes one :class:`Document` with ``file_path`` metadata (absolute,
like llama-index), read as UTF-8. Files are visited in sorted path order for
determinism.
"""

from __future__ import annotations

import os
from typing import List, Sequence

from ..schema import Document


def read_data(path: str = "data", required_exts: Sequence[str] = (".txt",)) -> List[Document]:
    docs: List[Document] = []
    root = os.path.abspath(path)
    paths: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for name in sorted(filenames):
            if any(name.endswith(ext) for ext in required_exts):
                paths.append(os.path.join(dirpath, name))
    paths.sort()
    for file_path in paths:
        with open(file_path, "r", encoding="utf-8", errors="replace") as f:
            text = f.read()
        docs.append(
            Document(
                text=text,
                metadata={
                    "file_path": file_path,
                    "file_name": os.path.basename(file_path),
                },
            )
        )
    return docs
