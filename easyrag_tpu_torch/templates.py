"""Prompt templates and a minimal template engine.

The template *strings* are behavioral constants of the pipeline, kept
byte-identical to the reference (``src/easyrag/custom/template.py``) —
answer quality parity depends on them, including leading indentation and
trailing whitespace the reference bakes into its literals. They live as
data in ``data/prompts.json`` (verified byte-equal during the build) and
load here as module attributes:

  QA_TEMPLATE                 context-grounded QA, answer-or-不确定
  MERGE_TEMPLATE              answer refinement (instruction repeated 3x)
  SUMMARY_EXTRACT_TEMPLATE    section summarization
  HYDE_PROMPT_ORIGIN          original English HyDE prompt
  HYDE_PROMPT_MODIFIED_V1/V2  Chinese ops-expert HyDE variants
  HYDE_PROMPT_MODIFIED_MERGING second-stage HyDE merge prompt

:class:`PromptTemplate` replaces llama-index's ``PromptTemplate`` used at
``src/easyrag/pipeline/pipeline.py:298-299``.
"""

from __future__ import annotations

import json
import os

_PROMPTS_PATH = os.path.join(os.path.dirname(__file__), "data", "prompts.json")

with open(_PROMPTS_PATH, encoding="utf-8") as _f:
    _PROMPTS = json.load(_f)

QA_TEMPLATE: str = _PROMPTS["QA_TEMPLATE"]
MERGE_TEMPLATE: str = _PROMPTS["MERGE_TEMPLATE"]
SUMMARY_EXTRACT_TEMPLATE: str = _PROMPTS["SUMMARY_EXTRACT_TEMPLATE"]
HYDE_PROMPT_ORIGIN: str = _PROMPTS["HYDE_PROMPT_ORIGIN"]
HYDE_PROMPT_MODIFIED_V1: str = _PROMPTS["HYDE_PROMPT_MODIFIED_V1"]
HYDE_PROMPT_MODIFIED_V2: str = _PROMPTS["HYDE_PROMPT_MODIFIED_V2"]
HYDE_PROMPT_MODIFIED_MERGING: str = _PROMPTS["HYDE_PROMPT_MODIFIED_MERGING"]


class PromptTemplate:
    """``str.format``-based template with named fields."""

    def __init__(self, template: str) -> None:
        self.template = template

    def format(self, **kwargs: str) -> str:
        return self.template.format(**kwargs)

    def __repr__(self) -> str:  # pragma: no cover
        return f"PromptTemplate({self.template[:40]!r}...)"
