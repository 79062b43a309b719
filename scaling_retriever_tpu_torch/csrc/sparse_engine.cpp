// Host CSR impact-scoring engine (the C++ hot lane and engine "cpp" of the
// PyTorch port; its own copy of the JAX package's native/sparse_engine.cpp,
// with the same C interface and the same results).
//
// Term-at-a-time scatter-add over CSR posting lists with per-thread score
// accumulators and a partial top-k. Queries are distributed over
// std::thread workers through an atomic cursor; each worker owns its
// accumulator and stamp buffers, so the engine is race-free by
// construction, and epoch stamping avoids a per-query memset of the
// collection-sized buffer.
//
// Built at first use by index/cpp_engine.py (g++ -O3 -std=c++17 -fPIC
// -pthread -Wall -shared) into build/native/<hash of source and flags>/.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Posting {
  const int64_t* offsets;   // [dim + 1]
  const int32_t* doc_rows;  // [nnz]
  const float* values;      // [nnz]
  int64_t dim;
  int64_t n_docs;
};

void score_one_query(const Posting& idx, const int32_t* q_terms,
                     const float* q_vals, int64_t q_len, int32_t topk,
                     float threshold, std::vector<float>& scores,
                     std::vector<int32_t>& stamp, int32_t epoch,
                     std::vector<int32_t>& touched, int32_t* out_rows,
                     float* out_scores) {
  touched.clear();
  for (int64_t t = 0; t < q_len; ++t) {
    const int32_t term = q_terms[t];
    if (term < 0 || term >= idx.dim) continue;
    const float qv = q_vals[t];
    const int64_t start = idx.offsets[term];
    const int64_t end = idx.offsets[term + 1];
    for (int64_t p = start; p < end; ++p) {
      const int32_t d = idx.doc_rows[p];
      const float contrib = qv * idx.values[p];
      if (stamp[d] != epoch) {
        stamp[d] = epoch;
        scores[d] = contrib;
        touched.push_back(d);
      } else {
        scores[d] += contrib;
      }
    }
  }
  // filter by threshold (reference keeps scores > threshold, indexer.py:342)
  std::vector<std::pair<float, int32_t>> cand;
  cand.reserve(touched.size());
  for (int32_t d : touched) {
    if (scores[d] > threshold) cand.emplace_back(scores[d], d);
  }
  const size_t k = std::min<size_t>(topk, cand.size());
  if (cand.size() > k) {
    std::nth_element(cand.begin(), cand.begin() + k, cand.end(),
                     [](const auto& a, const auto& b) { return a.first > b.first; });
    cand.resize(k);
  }
  std::sort(cand.begin(), cand.end(),
            [](const auto& a, const auto& b) { return a.first > b.first; });
  for (size_t i = 0; i < static_cast<size_t>(topk); ++i) {
    if (i < cand.size()) {
      out_rows[i] = cand[i].second;
      out_scores[i] = cand[i].first;
    } else {
      out_rows[i] = -1;
      out_scores[i] = 0.0f;
    }
  }
}

}  // namespace

extern "C" {

// Score nq queries against the CSR index; per query write topk (row, score)
// pairs sorted by descending score, -1 padded.
void srt_score_topk(const int64_t* offsets, const int32_t* doc_rows,
                    const float* values, int64_t dim, int64_t n_docs,
                    const int64_t* q_offsets, const int32_t* q_terms,
                    const float* q_vals, int64_t nq, int32_t topk,
                    float threshold, int32_t n_threads, int32_t* out_rows,
                    float* out_scores) {
  Posting idx{offsets, doc_rows, values, dim, n_docs};
  if (n_threads <= 0) {
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  n_threads = std::min<int64_t>(n_threads, std::max<int64_t>(nq, 1));

  std::atomic<int64_t> cursor{0};
  auto worker = [&]() {
    std::vector<float> scores(n_docs, 0.0f);
    std::vector<int32_t> stamp(n_docs, -1);
    std::vector<int32_t> touched;
    int32_t epoch = 0;
    while (true) {
      const int64_t qi = cursor.fetch_add(1);
      if (qi >= nq) break;
      ++epoch;
      score_one_query(idx, q_terms + q_offsets[qi], q_vals + q_offsets[qi],
                      q_offsets[qi + 1] - q_offsets[qi], topk, threshold,
                      scores, stamp, epoch, touched,
                      out_rows + qi * topk, out_scores + qi * topk);
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int32_t i = 0; i < n_threads; ++i) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// Build CSR offsets from term counts (helper for index construction).
void srt_counts_to_offsets(const int64_t* counts, int64_t dim, int64_t* offsets) {
  offsets[0] = 0;
  for (int64_t i = 0; i < dim; ++i) offsets[i + 1] = offsets[i] + counts[i];
}

}  // extern "C"
