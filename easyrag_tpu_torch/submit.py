"""Judge-server client (``src/submit.py``; a host copy of
``easyrag_tpu/submit.py``, ``urllib`` only).

Posts competition answers to the AIOps challenge judge and polls submission
status. Config-driven contest/ticket identifiers instead of hardcoded
constants; same wire format.
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import Any, Dict, List, Optional

JUDGE_URL = os.environ.get("EASYRAG_JUDGE_URL", "http://judge.aiops-challenge.com")


def submit(
    data: List[Dict[str, Any]],
    judge_url: str = JUDGE_URL,
    contest: Optional[str] = None,
    ticket: Optional[str] = None,
) -> str:
    """POST answers as a jsonl payload with contest/ticket headers."""
    contest = contest or os.environ.get("EASYRAG_CONTEST", "")
    ticket = ticket or os.environ.get("EASYRAG_TICKET", "")
    payload = "\n".join(json.dumps(row, ensure_ascii=False) for row in data).encode(
        "utf-8"
    )
    req = urllib.request.Request(
        url=f"{judge_url}/submit",
        data=payload,
        headers={
            "Content-Type": "application/json",
            "contest": contest,
            "ticket": ticket,
        },
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.read().decode("utf-8")


def check_status(
    submission_id: str,
    judge_url: str = JUDGE_URL,
    contest: Optional[str] = None,
    ticket: Optional[str] = None,
) -> str:
    contest = contest or os.environ.get("EASYRAG_CONTEST", "")
    ticket = ticket or os.environ.get("EASYRAG_TICKET", "")
    req = urllib.request.Request(
        url=f"{judge_url}/status/{submission_id}",
        headers={"contest": contest, "ticket": ticket},
        method="GET",
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.read().decode("utf-8")


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("command", choices=["submit", "status"])
    parser.add_argument("--file", default="submit_result.jsonl")
    parser.add_argument("--id", default="")
    args = parser.parse_args()
    if args.command == "submit":
        rows = [
            json.loads(line)
            for line in open(args.file, encoding="utf-8")
            if line.strip()
        ]
        print(submit(rows))
    else:
        print(check_status(args.id))
