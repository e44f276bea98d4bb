// Native sparse-index builder of easyrag_tpu_torch: a copy of the JAX
// package's native/bm25_index.cpp, built by easyrag_tpu_torch/native.py into
// build/native/ (the package never reads or writes the repository's native/).
//
// Replaces the Python corpus-statistics hot loop (index/sparse.py
// build_stats + eager_scores) for large corpora: vocabulary hashing over a
// flat UTF-8 token buffer, document-frequency counting, CSR postings
// packing, and eager BM25 contribution precomputation (Okapi epsilon-floor
// or bm25s/lucene variants) in one pass — the TPU-native framework's
// counterpart of the native index machinery the reference delegates to the
// qdrant server and rank_bm25/bm25s.
//
// C ABI (ctypes). The caller passes the token stream as one contiguous
// NUL-separated UTF-8 buffer (fast to build in Python with one
// "\\x00".join(...).encode()):
//   text_buf,buf_len: bytes of all tokens joined by '\0'
//   n_tokens        : number of tokens in the buffer
//   doc_offsets     : int64[n_docs+1]   token-index boundaries per doc
// Outputs are caller-allocated (worst case: P,V <= n_tokens):
//   token_term_ids  : int32[n_tokens]   term id per token position
//                     (ids assigned in first-appearance order, matching the
//                      Python builder exactly)
//   doc_lens        : int32[n_docs]
//   term_offsets    : int64[n_tokens+1] CSR offsets (first V+1 valid)
//   post_docs       : int32[n_tokens]   (first P valid)
//   post_tfs        : int32[n_tokens]
//   post_vals       : double[n_tokens]  eager contributions
// Returns V via *out_vocab and P via *out_postings; -1 on error.

#include <cstdint>
#include <cstring>
#include <string_view>
#include <unordered_map>
#include <vector>
#include <cmath>

extern "C" {

int64_t easyrag_build_bm25_index(
    const char* text_buf,
    int64_t buf_len,
    int64_t n_tokens,
    const int64_t* doc_offsets,
    int64_t n_docs,
    double k1,
    double b,
    double epsilon,
    int32_t bm25_type,
    int32_t* token_term_ids,
    int32_t* doc_lens,
    int64_t* term_offsets,
    int32_t* post_docs,
    int32_t* post_tfs,
    double* post_vals,
    int64_t* out_vocab,
    int64_t* out_postings,
    int64_t* first_token_pos) {
  if (n_tokens < 0 || n_docs < 0) return -1;

  // ---- pass 1: split NUL-separated buffer; vocabulary in
  // first-appearance order ----
  std::unordered_map<std::string_view, int32_t> vocab;
  vocab.reserve(static_cast<size_t>(n_tokens / 4 + 16));
  int64_t pos = 0;
  for (int64_t t = 0; t < n_tokens; ++t) {
    int64_t end = pos;
    while (end < buf_len && text_buf[end] != '\0') ++end;
    std::string_view tok(text_buf + pos, static_cast<size_t>(end - pos));
    auto it = vocab.find(tok);
    int32_t id;
    if (it == vocab.end()) {
      id = static_cast<int32_t>(vocab.size());
      vocab.emplace(tok, id);
      first_token_pos[id] = t;
    } else {
      id = it->second;
    }
    token_term_ids[t] = id;
    pos = end + 1;
  }
  const int64_t V = static_cast<int64_t>(vocab.size());

  // ---- pass 2: per-doc tf counting; postings per term in doc order ----
  // postings are term-major; count postings per term first
  std::vector<int64_t> term_df(V, 0);
  std::vector<int32_t> last_doc(V, -1);
  int64_t P = 0;
  double total_len = 0.0;
  for (int64_t d = 0; d < n_docs; ++d) {
    const int64_t lo = doc_offsets[d], hi = doc_offsets[d + 1];
    doc_lens[d] = static_cast<int32_t>(hi - lo);
    total_len += static_cast<double>(hi - lo);
    for (int64_t t = lo; t < hi; ++t) {
      const int32_t id = token_term_ids[t];
      if (last_doc[id] != d) {
        last_doc[id] = static_cast<int32_t>(d);
        ++term_df[id];
        ++P;
      }
    }
  }
  const double avgdl = n_docs ? total_len / static_cast<double>(n_docs) : 0.0;

  term_offsets[0] = 0;
  for (int64_t v = 0; v < V; ++v) term_offsets[v + 1] = term_offsets[v] + term_df[v];

  // ---- pass 3: fill postings (per-term cursor); tf by counting within doc ----
  std::vector<int64_t> cursor(term_offsets, term_offsets + V);
  std::fill(last_doc.begin(), last_doc.end(), -1);
  std::vector<int64_t> posting_slot(V, -1);
  for (int64_t d = 0; d < n_docs; ++d) {
    const int64_t lo = doc_offsets[d], hi = doc_offsets[d + 1];
    for (int64_t t = lo; t < hi; ++t) {
      const int32_t id = token_term_ids[t];
      if (last_doc[id] != d) {
        last_doc[id] = static_cast<int32_t>(d);
        const int64_t slot = cursor[id]++;
        posting_slot[id] = slot;
        post_docs[slot] = static_cast<int32_t>(d);
        post_tfs[slot] = 1;
      } else {
        ++post_tfs[posting_slot[id]];
      }
    }
  }

  // ---- IDF ----
  std::vector<double> idf(V);
  if (bm25_type == 1) {  // bm25s "lucene"
    for (int64_t v = 0; v < V; ++v) {
      const double df = static_cast<double>(term_df[v]);
      idf[v] = std::log(1.0 + (static_cast<double>(n_docs) - df + 0.5) / (df + 0.5));
    }
  } else {  // rank_bm25 Okapi with epsilon floor
    double idf_sum = 0.0;
    for (int64_t v = 0; v < V; ++v) {
      const double df = static_cast<double>(term_df[v]);
      idf[v] = std::log(static_cast<double>(n_docs) - df + 0.5) - std::log(df + 0.5);
      idf_sum += idf[v];
    }
    const double avg_idf = V ? idf_sum / static_cast<double>(V) : 0.0;
    for (int64_t v = 0; v < V; ++v) {
      if (idf[v] < 0) idf[v] = epsilon * avg_idf;
    }
  }

  // ---- eager per-posting contributions ----
  const double safe_avgdl = avgdl > 1e-12 ? avgdl : 1e-12;
  for (int64_t v = 0; v < V; ++v) {
    for (int64_t s = term_offsets[v]; s < term_offsets[v + 1]; ++s) {
      const double tf = static_cast<double>(post_tfs[s]);
      const double norm =
          k1 * (1.0 - b + b * static_cast<double>(doc_lens[post_docs[s]]) / safe_avgdl);
      if (bm25_type == 1) {
        post_vals[s] = idf[v] * tf / (tf + norm);
      } else {
        post_vals[s] = idf[v] * tf * (k1 + 1.0) / (tf + norm);
      }
    }
  }

  *out_vocab = V;
  *out_postings = P;
  return 0;
}

}  // extern "C"
