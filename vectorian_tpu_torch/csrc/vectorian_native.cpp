// Native host library of vectorian_tpu_torch: the port's own copy of the
// reference package's native/vectorian_native.cpp, built by
// vectorian_tpu_torch/native.py into vectorian_tpu_torch/_build/.  One
// change: the fastText mean divides by the subword count (as the python
// path's numpy mean does, so the two give the same bits) where the
// original multiplies by its reciprocal.
//
// The equivalent of the reference's C++ host-side hot paths
// (reference: vectorian/core/cpp/vocabulary.h string-interning arena,
// embedding/token/fasttext.py ngram encoding): byte-crunching work the
// CPython interpreter is slow at, exposed through a plain C ABI consumed
// via ctypes (no pybind11 dependency).
//

#include <cmath>
#include <limits>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- fastText

// FNV-1a 32-bit over sign-extended bytes (upstream fastText Dictionary::hash
// XORs int8_t values).
static inline uint32_t ft_hash(const char* s, int64_t len) {
  uint32_t h = 2166136261u;
  for (int64_t i = 0; i < len; i++) {
    h ^= static_cast<uint32_t>(static_cast<int8_t>(s[i]));
    h *= 16777619u;
  }
  return h;
}

uint32_t vn_ft_hash(const char* s, int64_t len) { return ft_hash(s, len); }

// Sum fastText subword rows for a batch of words.
//
// words: concatenated utf-8 bytes; offsets[i]..offsets[i+1] delimit word i
// (n_words+1 offsets).  word_row[i]: row of the full word in the input
// matrix, or -1 if OOV.  matrix: [rows, dim] float32 (nwords + bucket).
// out: [n_words, dim] float32 — the *mean* of word row + ngram rows.
void vn_ft_encode_batch(
    const char* words, const int64_t* offsets, const int64_t* word_rows,
    int64_t n_words, const float* matrix, int64_t rows, int64_t dim,
    int64_t nwords, int64_t bucket, int32_t minn, int32_t maxn,
    float* out) {
  std::string buf;
  for (int64_t w = 0; w < n_words; w++) {
    const char* word = words + offsets[w];
    const int64_t wlen = offsets[w + 1] - offsets[w];
    float* dst = out + w * dim;
    std::memset(dst, 0, sizeof(float) * dim);

    int64_t count = 0;
    if (word_rows[w] >= 0) {
      const float* src = matrix + word_rows[w] * dim;
      for (int64_t d = 0; d < dim; d++) dst[d] += src[d];
      count++;
    }
    if (maxn > 0 && !(wlen == 4 && std::memcmp(word, "</s>", 4) == 0)) {
      buf.clear();
      buf.push_back('<');
      buf.append(word, wlen);
      buf.push_back('>');
      const int64_t n = static_cast<int64_t>(buf.size());
      // iterate utf-8 aware: ngrams start at non-continuation bytes
      for (int64_t i = 0; i < n; i++) {
        if ((buf[i] & 0xC0) == 0x80) continue;  // utf-8 continuation
        std::string ngram;
        int64_t j = i;
        int32_t chars = 0;
        while (j < n && chars < maxn) {
          ngram.push_back(buf[j]);
          j++;
          while (j < n && (buf[j] & 0xC0) == 0x80) {
            ngram.push_back(buf[j]);
            j++;
          }
          chars++;
          // fastText computeSubwords: only 1-char EDGE ngrams are excluded
          // (the bare '<'/'>'); the full '<word>' ngram is included
          if (chars >= minn && !(chars == 1 && (i == 0 || j == n))) {
            const int64_t row =
                nwords + (ft_hash(ngram.data(), ngram.size()) % bucket);
            const float* src = matrix + row * dim;
            for (int64_t d = 0; d < dim; d++) dst[d] += src[d];
            count++;
          }
        }
      }
    }
    if (count > 0) {
      const float k = static_cast<float>(count);
      for (int64_t d = 0; d < dim; d++) dst[d] /= k;
    }
  }
}

// ---------------------------------------------------------------- interning

// A simple string-interning lexicon (reference vocabulary.h StringStorage +
// LexiconImpl).  Handle-based for ctypes.
struct Lexicon {
  std::unordered_map<std::string, int32_t> to_id;
  std::vector<std::string> strings;
};

void* vn_lexicon_new() {
  auto* lex = new Lexicon();
  lex->to_id.reserve(1 << 16);
  lex->strings.emplace_back("<pad>");
  lex->to_id.emplace("<pad>", 0);
  return lex;
}

void vn_lexicon_free(void* h) { delete static_cast<Lexicon*>(h); }

int64_t vn_lexicon_size(void* h) {
  return static_cast<int64_t>(static_cast<Lexicon*>(h)->strings.size());
}

// Intern a batch of words (concatenated bytes + offsets); writes int32 ids.
void vn_lexicon_add_many(void* h, const char* words, const int64_t* offsets,
                         int64_t n_words, int32_t* out_ids) {
  auto* lex = static_cast<Lexicon*>(h);
  for (int64_t w = 0; w < n_words; w++) {
    std::string s(words + offsets[w], offsets[w + 1] - offsets[w]);
    auto it = lex->to_id.find(s);
    if (it == lex->to_id.end()) {
      const int32_t id = static_cast<int32_t>(lex->strings.size());
      lex->strings.push_back(s);
      it = lex->to_id.emplace(std::move(s), id).first;
    }
    out_ids[w] = it->second;
  }
}

// Lookup without interning; -1 for unknown.
void vn_lexicon_lookup_many(void* h, const char* words, const int64_t* offsets,
                            int64_t n_words, int32_t* out_ids) {
  auto* lex = static_cast<Lexicon*>(h);
  for (int64_t w = 0; w < n_words; w++) {
    std::string s(words + offsets[w], offsets[w + 1] - offsets[w]);
    auto it = lex->to_id.find(s);
    out_ids[w] = (it == lex->to_id.end()) ? -1 : it->second;
  }
}

// ---------------------------------------------------------------- packing

// Fill padded, length-bucketed slice matrices from flat per-corpus arrays
// (the reference's Spans::iterate + unpack_tokens hot loop,
// document.h:147-169 + vocabulary.cpp:8-54, as straight memcpy rows).
//
// flat_*: concatenated per-document token columns; starts[i] is slice i's
// absolute offset into them, lens[i] its token count (<= cap).  out_* are
// zero-initialised [n, cap] row-major buffers.
void vn_pack_fill(const int32_t* flat_tok, const int8_t* flat_pos,
                  const int16_t* flat_tag, const int64_t* starts,
                  const int32_t* lens, int64_t n, int64_t cap,
                  int32_t* out_tok, int8_t* out_pos, int16_t* out_tag) {
  for (int64_t i = 0; i < n; i++) {
    const int64_t s = starts[i];
    const int64_t l = lens[i];
    std::memcpy(out_tok + i * cap, flat_tok + s, sizeof(int32_t) * l);
    std::memcpy(out_pos + i * cap, flat_pos + s, sizeof(int8_t) * l);
    std::memcpy(out_tag + i * cap, flat_tag + s, sizeof(int16_t) * l);
  }
}

// ------------------------------------------------------------- traceback
//
// Host traceback of the alignment DP (the reference's InjectiveFlow
// extraction, match/match.h:52-133), batched over the finalizer's top-k
// rescore rows: the python per-row loop costs ~0.15 ms/row, which at the
// serving batch's ~1.3k tracebacks dominated host time.  Must reproduce
// ops/alignment.py traceback()/traceback_general() BIT-EXACTLY under
// numpy 2 promotion rules: H/S/gap-vector entries are float32, python-float
// gap constants are weak scalars (cast to f32 before the op), comparisons
// against python-float eps cast the eps to f32
// (tests/test_native_traceback.py fuzzes native vs python).

static void tb_seed(const float* H, int ls, int lt, int64_t T1, int locality,
                    int* pi, int* pj) {
  if (locality == 1) {  // global
    *pi = ls;
    *pj = lt;
    return;
  }
  if (locality == 0) {  // local: first max of H[1..ls, 1..lt], row-major
    float best = -std::numeric_limits<float>::infinity();
    int bi = 1, bj = 1;
    for (int r = 1; r <= ls; r++)
      for (int c = 1; c <= lt; c++) {
        const float v = H[r * T1 + c];
        if (v > best) {
          best = v;
          bi = r;
          bj = c;
        }
      }
    *pi = bi;
    *pj = bj;
    return;
  }
  // semiglobal: max over last column vs last row (column wins ties)
  float colmax = -std::numeric_limits<float>::infinity();
  int ci = 0;
  for (int r = 0; r <= ls; r++) {
    const float v = H[r * T1 + lt];
    if (v > colmax) {
      colmax = v;
      ci = r;
    }
  }
  float rowmax = -std::numeric_limits<float>::infinity();
  int rj = 0;
  for (int c = 0; c <= lt; c++) {
    const float v = H[ls * T1 + c];
    if (v > rowmax) {
      rowmax = v;
      rj = c;
    }
  }
  if (colmax >= rowmax) {
    *pi = ci;
    *pj = lt;
  } else {
    *pi = ls;
    *pj = rj;
  }
}

// H: [B, S1, T1] f32 DP matrices; S: [B, Ls, Lt] f32 similarities;
// len_s/len_t: [B]; locality: 0 local / 1 global / 2 semiglobal;
// end_cells: [B, 2] 1-based (i, j) seeds or null; mapping out: [B, Lt]
// (t index -> s index or -1).
void vn_traceback_affine_batch(
    const float* H_all, const float* S_all, const int32_t* len_s,
    const int32_t* len_t, int64_t B, int64_t S1, int64_t T1, int64_t Ls,
    int64_t Lt, double open_s, double extend_s, double open_t,
    double extend_t, int locality, const int32_t* end_cells,
    int32_t* mapping_all) {
  const double decay_t = open_t < extend_t ? open_t : extend_t;
  const double decay_s = open_s < extend_s ? open_s : extend_s;
  const float eps = 1e-4f;
  for (int64_t b = 0; b < B; b++) {
    const float* H = H_all + b * S1 * T1;
    const float* S = S_all + b * Ls * Lt;
    int32_t* mapping = mapping_all + b * Lt;
    const int ls = len_s[b], lt = len_t[b];
    for (int64_t j = 0; j < Lt; j++) mapping[j] = -1;
    int i, j;
    if (end_cells != nullptr) {
      i = end_cells[2 * b];
      j = end_cells[2 * b + 1];
    } else {
      tb_seed(H, ls, lt, T1, locality, &i, &j);
    }
    while (i > 0 && j > 0) {
      const float h = H[i * T1 + j];
      if (locality == 0 && h <= 1e-9f) break;
      const float dd = H[(i - 1) * T1 + (j - 1)] + S[(i - 1) * Lt + (j - 1)] - h;
      if (std::fabs(dd) <= eps) {
        mapping[j - 1] = i - 1;
        i--;
        j--;
        continue;
      }
      bool matched = false;
      for (int g = 1; g <= j; g++) {
        const float cost = (float)(open_t + (double)(g - 1) * decay_t);
        if (std::fabs(H[i * T1 + (j - g)] - cost - h) <= eps) {
          j -= g;
          matched = true;
          break;
        }
      }
      if (matched) continue;
      for (int g = 1; g <= i; g++) {
        const float cost = (float)(open_s + (double)(g - 1) * decay_s);
        if (std::fabs(H[(i - g) * T1 + j] - cost - h) <= eps) {
          i -= g;
          matched = true;
          break;
        }
      }
      if (matched) continue;
      // numerical fallback: best-looking predecessor, diag > t-gap > s-gap
      // on ties (python max keeps the first maximal candidate)
      const float c0 = H[(i - 1) * T1 + (j - 1)] + S[(i - 1) * Lt + (j - 1)];
      const float c1 = H[i * T1 + (j - 1)] - (float)decay_t;
      const float c2 = H[(i - 1) * T1 + j] - (float)decay_s;
      float best = c0;
      int mv = 0;
      if (c1 > best) {
        best = c1;
        mv = 1;
      }
      if (c2 > best) {
        mv = 2;
      }
      if (mv == 0) {
        mapping[j - 1] = i - 1;
        i--;
        j--;
      } else if (mv == 1) {
        j--;
      } else {
        i--;
      }
    }
  }
}

// General-gap variant: per-length cost vectors w_s [S1], w_t [T1] (f32,
// matching ops/alignment.py traceback_general).
void vn_traceback_general_batch(
    const float* H_all, const float* S_all, const int32_t* len_s,
    const int32_t* len_t, int64_t B, int64_t S1, int64_t T1, int64_t Ls,
    int64_t Lt, const float* w_s, const float* w_t, int locality,
    const int32_t* end_cells, int32_t* mapping_all) {
  const float eps = 1e-4f;
  for (int64_t b = 0; b < B; b++) {
    const float* H = H_all + b * S1 * T1;
    const float* S = S_all + b * Ls * Lt;
    int32_t* mapping = mapping_all + b * Lt;
    const int ls = len_s[b], lt = len_t[b];
    for (int64_t j = 0; j < Lt; j++) mapping[j] = -1;
    int i, j;
    if (end_cells != nullptr) {
      i = end_cells[2 * b];
      j = end_cells[2 * b + 1];
    } else {
      tb_seed(H, ls, lt, T1, locality, &i, &j);
    }
    while (i > 0 && j > 0) {
      const float h = H[i * T1 + j];
      if (locality == 0 && h <= 1e-9f) break;
      const float dd = H[(i - 1) * T1 + (j - 1)] + S[(i - 1) * Lt + (j - 1)] - h;
      if (std::fabs(dd) <= eps) {
        mapping[j - 1] = i - 1;
        i--;
        j--;
        continue;
      }
      bool matched = false;
      for (int g = 1; g <= j; g++) {
        if (std::fabs(H[i * T1 + (j - g)] - w_t[g] - h) <= eps) {
          j -= g;
          matched = true;
          break;
        }
      }
      if (matched) continue;
      for (int g = 1; g <= i; g++) {
        if (std::fabs(H[(i - g) * T1 + j] - w_s[g] - h) <= eps) {
          i -= g;
          matched = true;
          break;
        }
      }
      if (matched) continue;
      // numerical fallback (traceback_general: unconditional diagonal)
      mapping[j - 1] = i - 1;
      i--;
      j--;
    }
  }
}

// ------------------------------------------------------------- exact EMD
//
// Exact balanced transportation problem (min sum C[i][j]*x[i][j] s.t. row
// sums = a, column sums = b, x >= 0) via successive shortest paths with
// node potentials — the same exact-EMD family as the reference's vendored
// pyemd emd_hat (vectorian/core/cpp/alignment/pyemd.h:11-17, a min-cost
// flow), replacing a ~ms scipy HiGHS LP per candidate in the host rescore
// with a ~µs solve.  The optimal COST is the unique LP optimum, so scores
// (ops/emd_exact.emd_score) match the scipy path to fp tolerance; the flow
// matrix is one deterministic optimal vertex (ties may pick a different
// vertex than HiGHS — tests compare costs and marginals, not vertices).
//
// Requires C >= 0 (Dijkstra; WMD costs are max(MAX_SIM - S, 0) plus a
// non-negative sink penalty).  Returns 0 on success, -1 on failure (caller
// falls back to scipy).

int vn_emd(const double* a, const double* b, const double* C,
           int64_t n1_, int64_t n2_, double* flow, double* cost_out) {
  const int n1 = static_cast<int>(n1_), n2 = static_cast<int>(n2_);
  const int N = n1 + n2;
  const double INF = std::numeric_limits<double>::infinity();
  *cost_out = 0.0;
  for (int64_t k = 0; k < n1_ * n2_; k++) {
    flow[k] = 0.0;
    if (!(C[k] >= 0.0)) return -1;  // negative or NaN cost
  }
  std::vector<double> rem_a(a, a + n1), rem_b(b, b + n2);
  double tot_a = 0.0, tot_b = 0.0;
  for (int i = 0; i < n1; i++) {
    if (!(rem_a[i] >= 0.0)) return -1;
    tot_a += rem_a[i];
  }
  for (int j = 0; j < n2; j++) {
    if (!(rem_b[j] >= 0.0)) return -1;
    tot_b += rem_b[j];
  }
  const double scale = tot_a > tot_b ? tot_a : tot_b;
  if (scale <= 0.0) return -1;
  if (std::fabs(tot_a - tot_b) > 1e-9 * scale) return -1;  // not balanced
  const double eps = 1e-12 * scale;

  std::vector<double> pot(N, 0.0), dist(N);
  std::vector<int> prev(N);
  std::vector<char> done(N);
  // each augmentation zeroes a supply or demand (or empties a backward
  // edge); the guard bounds pathological degeneracy -> scipy fallback
  int guard = 16 * N * N + 256;

  while (true) {
    double rem_s = 0.0, rem_d = 0.0;
    for (int i = 0; i < n1; i++) rem_s += rem_a[i];
    for (int j = 0; j < n2; j++) rem_d += rem_b[j];
    if (rem_s <= eps || rem_d <= eps) break;
    if (--guard < 0) return -1;

    // dense Dijkstra over reduced costs (N is tiny: slice+needle tokens)
    for (int v = 0; v < N; v++) {
      dist[v] = INF;
      prev[v] = -1;
      done[v] = 0;
    }
    for (int i = 0; i < n1; i++)
      if (rem_a[i] > eps) dist[i] = 0.0;
    for (int it = 0; it < N; it++) {
      int u = -1;
      double du = INF;
      for (int v = 0; v < N; v++)
        if (!done[v] && dist[v] < du) {
          du = dist[v];
          u = v;
        }
      if (u < 0) break;
      done[u] = 1;
      if (u < n1) {
        // left node: forward edges u -> every right node (infinite cap)
        const double* Cu = C + static_cast<int64_t>(u) * n2;
        for (int j = 0; j < n2; j++) {
          double rc = Cu[j] + pot[u] - pot[n1 + j];
          if (rc < 0.0) rc = 0.0;  // fp noise; exact potentials keep rc >= 0
          const double nd = du + rc;
          if (nd < dist[n1 + j]) {
            dist[n1 + j] = nd;
            prev[n1 + j] = u;
          }
        }
      } else {
        // right node: backward edges u -> left i for carried flow
        const int j = u - n1;
        for (int i = 0; i < n1; i++) {
          if (flow[static_cast<int64_t>(i) * n2 + j] > eps) {
            double rc = -C[static_cast<int64_t>(i) * n2 + j] + pot[u] - pot[i];
            if (rc < 0.0) rc = 0.0;
            const double nd = du + rc;
            if (nd < dist[i]) {
              dist[i] = nd;
              prev[i] = u;
            }
          }
        }
      }
    }
    // closest right node with remaining demand
    int t = -1;
    double dbest = INF;
    for (int j = 0; j < n2; j++)
      if (rem_b[j] > eps && dist[n1 + j] < dbest) {
        dbest = dist[n1 + j];
        t = n1 + j;
      }
    if (t < 0) return -1;  // unreachable demand (cannot happen: complete graph)
    for (int v = 0; v < N; v++)
      pot[v] += dist[v] < dbest ? dist[v] : dbest;

    // bottleneck along the path (forward edges are uncapacitated)
    double delta = rem_b[t - n1];
    int v = t;
    while (prev[v] != -1) {
      const int u = prev[v];
      if (u >= n1) {  // backward edge: reduces flow[v][u - n1]
        const double f = flow[static_cast<int64_t>(v) * n2 + (u - n1)];
        if (f < delta) delta = f;
      }
      v = u;
    }
    const int src = v;  // left node that seeded the path
    if (rem_a[src] < delta) delta = rem_a[src];
    if (delta <= 0.0) return -1;  // degenerate stall
    v = t;
    while (prev[v] != -1) {
      const int u = prev[v];
      if (u < n1)
        flow[static_cast<int64_t>(u) * n2 + (v - n1)] += delta;
      else
        flow[static_cast<int64_t>(v) * n2 + (u - n1)] -= delta;
      v = u;
    }
    rem_a[src] -= delta;
    rem_b[t - n1] -= delta;
  }

  double cost = 0.0;
  for (int64_t k = 0; k < n1_ * n2_; k++) cost += flow[k] * C[k];
  *cost_out = cost;
  return 0;
}

// Threaded batch of independent EMD solves — the transport serving
// batch's exact rescore runs hundreds to thousands of small
// (query x candidate-slice) problems per round, and the per-problem SSP
// solves share nothing, so threads partition them round-robin.  Problems
// are variable-sized, flattened with per-problem offsets (a at a_off[k],
// b at b_off[k], C and flow at c_off[k]); rcs[k] = vn_emd's return for
// problem k (callers fall back per problem on -1).
void vn_emd_batch(const double* a, const double* b, const double* C,
                  const int64_t* n1s, const int64_t* n2s,
                  const int64_t* a_off, const int64_t* b_off,
                  const int64_t* c_off, int64_t B, int64_t n_threads,
                  double* flow, double* costs, int32_t* rcs) {
  if (B <= 0) return;
  int64_t nt = n_threads;
  if (nt <= 0) {
    nt = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (nt <= 0) nt = 1;
  }
  if (nt > B) nt = B;
  auto work = [&](int64_t t0) {
    for (int64_t k = t0; k < B; k += nt) {
      rcs[k] = vn_emd(a + a_off[k], b + b_off[k], C + c_off[k], n1s[k],
                      n2s[k], flow + c_off[k], costs + k);
    }
  };
  if (nt == 1) {
    work(0);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int64_t t = 0; t < nt; t++) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
}

// Copy string i into buf (returns length; buf may be null to query size).
int64_t vn_lexicon_get(void* h, int64_t i, char* buf, int64_t buf_len) {
  auto* lex = static_cast<Lexicon*>(h);
  if (i < 0 || i >= static_cast<int64_t>(lex->strings.size())) return -1;
  const std::string& s = lex->strings[i];
  if (buf != nullptr) {
    const int64_t n =
        std::min<int64_t>(buf_len, static_cast<int64_t>(s.size()));
    std::memcpy(buf, s.data(), n);
  }
  return static_cast<int64_t>(s.size());
}

}  // extern "C"
