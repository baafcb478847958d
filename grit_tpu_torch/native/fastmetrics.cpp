// fastmetrics: native PTB tokenization + CIDEr-D scoring for grit_tpu_torch
// (the port's own copy of grit_tpu/native/fastmetrics.cpp).
//
// The reference shells out to two Java jars for its metric hot path —
// stanford-corenlp PTBTokenizer (datasets/caption/metrics/tokenizer.py:16-66)
// and meteor-1.5 (metrics/meteor/meteor.py) — and computes CIDEr-D in Python
// dict-land (metrics/cider/cider_scorer.py).  During SCST every training
// batch pays tokenize+CIDEr on the host (engine/caption_engine.py:432-437),
// so this library provides the native equivalents used by
// grit_tpu_torch.data.metrics via ctypes:
//
//   - ptb_tokenize_batch: lowercase, split punctuation/contractions, drop the
//     standard caption punctuation set (same conventions as the Python
//     implementation in grit_tpu_torch/data/tokenizer.py — outputs are identical);
//   - CiderCorpus: n-gram document frequencies from training references;
//   - cider_scores: CIDEr-D per candidate, algorithm-parity with the
//     coco-caption scorer (clipped tf-idf cosine per n, bigram-count length
//     gaussian, 10 * mean over n, averaged over refs).
//
// Interface: C ABI, newline-joined string batches to keep marshaling flat.
// Build: g++ -O3 -shared -fPIC at first use, into grit_tpu_torch/_build/
// (see grit_tpu_torch/native/__init__.py).

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// ---------------------------------------------------------------- tokenizer

const std::unordered_set<std::string>& punct_set() {
  static const std::unordered_set<std::string> kPunct = {
      "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
      ".",  "?", "!",  ",", ":",     "-",     "--",    "...",  ";"};
  return kPunct;
}

bool is_word_char(char c) { return std::isalnum((unsigned char)c) || c == '_'; }

// contraction suffixes to split off (longest first)
const char* kContractions[] = {"n't", "'re", "'ve", "'ll", "'s", "'d", "'m"};

void tokenize_line2(const std::string& line, std::vector<std::string>* out) {
  std::string s;
  s.reserve(line.size());
  for (char c : line) s.push_back((char)std::tolower((unsigned char)c));

  size_t i = 0;
  const size_t n = s.size();
  std::vector<std::string> raw;
  while (i < n) {
    char c = s[i];
    if (std::isspace((unsigned char)c)) { ++i; continue; }
    if (is_word_char(c) || (c == '\'' && i + 1 < n && is_word_char(s[i + 1]))) {
      size_t j = i;
      while (j < n &&
             (is_word_char(s[j]) ||
              (s[j] == '\'' && j + 1 < n && is_word_char(s[j + 1])) ||
              ((s[j] == '.' || s[j] == ',') && j + 1 < n && j > i &&
               std::isdigit((unsigned char)s[j - 1]) &&
               std::isdigit((unsigned char)s[j + 1])))) {
        ++j;
      }
      raw.emplace_back(s.substr(i, j - i));
      i = j;
    } else if (c == '.' && i + 2 < n && s[i + 1] == '.' && s[i + 2] == '.') {
      raw.emplace_back("...");
      i += 3;
    } else if (c == '-' && i + 1 < n && s[i + 1] == '-') {
      raw.emplace_back("--");
      i += 2;
    } else {
      raw.emplace_back(std::string(1, c));
      ++i;
    }
  }

  for (auto& tok : raw) {
    bool split = false;
    for (const char* suf : kContractions) {
      size_t ls = std::strlen(suf);
      if (tok.size() > ls && tok.compare(tok.size() - ls, ls, suf) == 0) {
        std::string head = tok.substr(0, tok.size() - ls);
        std::string tail = tok.substr(tok.size() - ls);
        if (punct_set().find(head) == punct_set().end() && !head.empty())
          out->push_back(head);
        if (punct_set().find(tail) == punct_set().end()) out->push_back(tail);
        split = true;
        break;
      }
    }
    if (!split) {
      // split any embedded apostrophe pieces that weren't contractions
      if (punct_set().find(tok) == punct_set().end()) out->push_back(tok);
    }
  }
}

// ---------------------------------------------------------------- n-grams

using NgramKey = uint64_t;

inline uint64_t fnv1a(uint64_t h, uint32_t v) {
  h ^= v;
  h *= 1099511628211ULL;
  return h;
}

struct Interner {
  std::unordered_map<std::string, uint32_t> map;
  uint32_t get(const std::string& w) {
    auto it = map.find(w);
    if (it != map.end()) return it->second;
    uint32_t id = (uint32_t)map.size();
    map.emplace(w, id);
    return id;
  }
};

constexpr int kN = 4;

// counts for n-grams of a tokenized sentence (word ids)
void ngram_counts(const std::vector<uint32_t>& words,
                  std::unordered_map<NgramKey, int> out[kN]) {
  const size_t len = words.size();
  for (size_t i = 0; i < len; ++i) {
    uint64_t h = 1469598103934665603ULL;
    for (int k = 0; k < kN && i + k < len; ++k) {
      h = fnv1a(h, words[i + k] + 1);
      out[k][h] += 1;
    }
  }
}

struct Corpus {
  Interner interner;
  std::unordered_map<NgramKey, double> df[kN];
  double ref_len = 0.0;  // log(#images)
};

std::vector<std::string> split_lines(const char* joined) {
  std::vector<std::string> out;
  const char* p = joined;
  const char* start = p;
  for (;; ++p) {
    if (*p == '\n' || *p == '\0') {
      out.emplace_back(start, p - start);
      if (*p == '\0') break;
      start = p + 1;
    }
  }
  return out;
}

std::vector<uint32_t> intern_tokens(const std::string& line, Interner* in) {
  std::vector<uint32_t> ids;
  const char* p = line.c_str();
  const char* start = p;
  std::string w;
  for (;; ++p) {
    if (*p == ' ' || *p == '\0') {
      if (p > start) {
        w.assign(start, p - start);
        ids.push_back(in->get(w));
      }
      if (*p == '\0') break;
      start = p + 1;
    }
  }
  return ids;
}

struct TfIdf {
  std::unordered_map<NgramKey, double> vec[kN];
  double norm[kN] = {0, 0, 0, 0};
  int length = 0;  // bigram count (coco-caption quirk)
};

void counts_to_vec(const std::unordered_map<NgramKey, int> cnts[kN],
                   const Corpus& corpus, TfIdf* out) {
  for (int k = 0; k < kN; ++k) {
    for (const auto& kv : cnts[k]) {
      auto it = corpus.df[k].find(kv.first);
      double df = it == corpus.df[k].end() ? 0.0 : it->second;
      double idf = corpus.ref_len - std::log(std::max(1.0, df));
      double w = kv.second * idf;
      out->vec[k][kv.first] = w;
      out->norm[k] += w * w;
      if (k == 1) out->length += kv.second;
    }
    out->norm[k] = std::sqrt(out->norm[k]);
  }
}

double sim(const TfIdf& hyp, const TfIdf& ref, double sigma) {
  double delta = (double)(hyp.length - ref.length);
  double pen = std::exp(-(delta * delta) / (2 * sigma * sigma));
  double total = 0.0;
  for (int k = 0; k < kN; ++k) {
    double v = 0.0;
    for (const auto& kv : hyp.vec[k]) {
      auto it = ref.vec[k].find(kv.first);
      if (it != ref.vec[k].end())
        v += std::min(kv.second, it->second) * it->second;
    }
    if (hyp.norm[k] != 0 && ref.norm[k] != 0) v /= hyp.norm[k] * ref.norm[k];
    total += v * pen;
  }
  return total;
}

}  // namespace

extern "C" {

// Tokenize a batch of newline-joined captions; returns a malloc'd
// newline-joined buffer of space-joined tokens.  Caller frees with fm_free.
char* fm_ptb_tokenize(const char* joined) {
  auto lines = split_lines(joined);
  std::string out;
  out.reserve(strlen(joined) + 16);
  std::vector<std::string> toks;
  for (size_t i = 0; i < lines.size(); ++i) {
    toks.clear();
    tokenize_line2(lines[i], &toks);
    for (size_t t = 0; t < toks.size(); ++t) {
      if (t) out.push_back(' ');
      out += toks[t];
    }
    if (i + 1 < lines.size()) out.push_back('\n');
  }
  char* buf = (char*)malloc(out.size() + 1);
  memcpy(buf, out.c_str(), out.size() + 1);
  return buf;
}

void fm_free(void* p) { free(p); }

// Build a CIDEr idf corpus from newline-joined PRE-TOKENIZED references,
// grouped per image: image i owns refs [offsets[i], offsets[i+1]).
void* fm_cider_corpus_new(const char* joined_refs, const int32_t* offsets,
                          int32_t n_images) {
  auto* corpus = new Corpus();
  auto lines = split_lines(joined_refs);
  for (int32_t img = 0; img < n_images; ++img) {
    std::unordered_set<NgramKey> seen[kN];
    for (int32_t r = offsets[img]; r < offsets[img + 1]; ++r) {
      auto ids = intern_tokens(lines[r], &corpus->interner);
      std::unordered_map<NgramKey, int> cnts[kN];
      ngram_counts(ids, cnts);
      for (int k = 0; k < kN; ++k)
        for (const auto& kv : cnts[k]) seen[k].insert(kv.first);
    }
    for (int k = 0; k < kN; ++k)
      for (NgramKey key : seen[k]) corpus->df[k][key] += 1.0;
  }
  corpus->ref_len = std::log((double)n_images);
  return corpus;
}

void fm_cider_corpus_free(void* handle) { delete (Corpus*)handle; }

// CIDEr-D for n_images candidates (one per image, newline-joined, tokenized)
// against grouped refs; writes scores[n_images].  If handle is null, the idf
// corpus is computed from these refs (the non-precomputed mode).
void fm_cider_scores(void* handle, const char* joined_cands,
                     const char* joined_refs, const int32_t* ref_offsets,
                     int32_t n_images, double sigma, double* scores) {
  Corpus local;
  Corpus* corpus = (Corpus*)handle;
  auto ref_lines = split_lines(joined_refs);
  if (corpus == nullptr) {
    corpus = &local;
    for (int32_t img = 0; img < n_images; ++img) {
      std::unordered_set<NgramKey> seen[kN];
      for (int32_t r = ref_offsets[img]; r < ref_offsets[img + 1]; ++r) {
        auto ids = intern_tokens(ref_lines[r], &local.interner);
        std::unordered_map<NgramKey, int> cnts[kN];
        ngram_counts(ids, cnts);
        for (int k = 0; k < kN; ++k)
          for (const auto& kv : cnts[k]) seen[k].insert(kv.first);
      }
      for (int k = 0; k < kN; ++k)
        for (NgramKey key : seen[k]) local.df[k][key] += 1.0;
    }
    local.ref_len = std::log((double)n_images);
  }

  auto cand_lines = split_lines(joined_cands);
  for (int32_t img = 0; img < n_images; ++img) {
    std::unordered_map<NgramKey, int> ccnts[kN];
    auto cids = intern_tokens(cand_lines[img], &corpus->interner);
    ngram_counts(cids, ccnts);
    TfIdf cvec;
    counts_to_vec(ccnts, *corpus, &cvec);

    double total = 0.0;
    int nrefs = ref_offsets[img + 1] - ref_offsets[img];
    for (int32_t r = ref_offsets[img]; r < ref_offsets[img + 1]; ++r) {
      std::unordered_map<NgramKey, int> rcnts[kN];
      auto rids = intern_tokens(ref_lines[r], &corpus->interner);
      ngram_counts(rids, rcnts);
      TfIdf rvec;
      counts_to_vec(rcnts, *corpus, &rvec);
      total += sim(cvec, rvec, sigma);
    }
    scores[img] = 10.0 * (total / kN) / std::max(nrefs, 1);
  }
}

}  // extern "C"
