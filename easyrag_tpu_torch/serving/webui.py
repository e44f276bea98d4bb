"""Web clients for the HTTP API (``src/webui.py``; port of
``easyrag_tpu/serving/webui.py``).

Three forms of the same client, so the surface exists in every runtime:

* a dependency-free HTML/JS page (:data:`HTML_PAGE`) served by the API
  itself at ``GET /ui`` — query box, document-source dropdown, answer +
  expandable context docs, exactly the reference's streamlit layout
  (``src/webui.py:20-47``) without needing streamlit;
* the streamlit app, when streamlit is installed;
* a terminal client (``python -m easyrag_tpu_torch.serving.webui --query ...``).
"""

from __future__ import annotations

import json
import urllib.request

API_URL = "http://127.0.0.1:8000/v1/rag"
DOCUMENT_CHOICES = ["无", "director", "emsplus", "rcp", "umac"]

HTML_PAGE = """<!doctype html>
<html lang="zh">
<head>
<meta charset="utf-8">
<title>EasyRAG 问答</title>
<style>
  body { font-family: system-ui, sans-serif; max-width: 46rem;
         margin: 2rem auto; padding: 0 1rem; color: #1a1a1a; }
  h1 { font-size: 1.4rem; }
  textarea { width: 100%; min-height: 5rem; font: inherit; padding: .5rem;
             box-sizing: border-box; }
  select, button { font: inherit; padding: .4rem .8rem; margin-top: .5rem; }
  button { cursor: pointer; }
  #answer { margin-top: 1.2rem; white-space: pre-wrap; }
  details { margin-top: .6rem; border: 1px solid #ddd; border-radius: 4px;
            padding: .4rem .6rem; }
  details pre { white-space: pre-wrap; margin: .4rem 0 0; }
  #status { color: #666; margin-left: .6rem; }
</style>
</head>
<body>
<h1>EasyRAG 问答</h1>
<form id="ask">
  <textarea id="query" placeholder="问题"></textarea><br>
  <label>文档来源
    <select id="document">
      <option>无</option><option>director</option><option>emsplus</option>
      <option>rcp</option><option>umac</option>
    </select>
  </label>
  <button type="submit">提问</button><span id="status"></span>
</form>
<div id="answer"></div>
<div id="contexts"></div>
<script>
document.getElementById("ask").addEventListener("submit", async (ev) => {
  ev.preventDefault();
  const query = document.getElementById("query").value.trim();
  if (!query) return;
  const docSel = document.getElementById("document").value;
  const status = document.getElementById("status");
  status.textContent = "检索中…";
  try {
    const resp = await fetch("/v1/rag", {
      method: "POST",
      headers: {"Content-Type": "application/json"},
      body: JSON.stringify({query, document: docSel === "无" ? "" : docSel}),
    });
    const data = await resp.json();
    if (!resp.ok) throw new Error(data.error || resp.status);
    document.getElementById("answer").textContent = data.answer;
    const ctxs = document.getElementById("contexts");
    ctxs.innerHTML = "";
    (data.contexts || []).forEach((c, i) => {
      const d = document.createElement("details");
      const s = document.createElement("summary");
      s.textContent = "文档" + i;
      const pre = document.createElement("pre");
      pre.textContent = c;
      d.append(s, pre);
      ctxs.append(d);
    });
    status.textContent = "";
  } catch (e) {
    status.textContent = "出错: " + e.message;
  }
});
</script>
</body>
</html>
"""


def ask(query: str, document: str = "", api_url: str = API_URL) -> dict:
    payload = json.dumps(
        {"query": query, "document": "" if document == "无" else document}
    ).encode("utf-8")
    req = urllib.request.Request(
        api_url, data=payload, headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read().decode("utf-8"))


def streamlit_app() -> None:  # pragma: no cover - needs streamlit runtime
    import streamlit as st

    st.title("EasyRAG 问答")
    with st.form("ask"):
        query = st.text_area("问题")
        document = st.selectbox("文档来源", DOCUMENT_CHOICES)
        submitted = st.form_submit_button("提问")
    if submitted and query:
        res = ask(query, document)
        st.markdown(res["answer"])
        for i, ctx in enumerate(res.get("contexts", [])):
            with st.expander(f"文档{i}"):
                st.text(ctx)


def _main() -> None:
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--query", required=True)
    parser.add_argument("--document", default="")
    parser.add_argument("--api-url", default=API_URL)
    args = parser.parse_args()
    res = ask(args.query, args.document, args.api_url)
    print(res["answer"])
    for i, ctx in enumerate(res.get("contexts", [])):
        print(f"\n### 文档{i}\n{ctx[:500]}")


try:  # streamlit execs this file top-level
    import streamlit  # noqa: F401

    _HAS_STREAMLIT = True
except ImportError:
    _HAS_STREAMLIT = False

if _HAS_STREAMLIT and __name__ != "__main__":  # pragma: no cover
    streamlit_app()

if __name__ == "__main__":
    _main()
