// Lexicon-constrained CTC prefix beam search with backoff n-gram LM.
//
// Native decode engine of neural_speech_decoder_tpu_torch (a copy of the
// JAX package's csrc/ctc_beam.cpp, same ABI version): the host-side
// equivalent of the upstream Kaldi/OpenFST `LanguageModelDecoder` the
// reference imports externally (reference scripts/eval_competition.py:88-116),
// re-designed as a lean standalone library:
//   * pronunciation-trie-constrained prefix beam search over CTC
//     log-probs (blank id 0, SIL id 40 as the word delimiter),
//   * ARPA backoff n-gram LM applied incrementally at word commits,
//   * homophone branching, n-best extraction, acoustic scale /
//     blank penalty / LM weight / word insertion penalty knobs,
//   * optional OOV fallback: a parallel lexicon-free phone track entered
//     at word boundaries, charged `oov_cost` per phone, committing `<unk>`
//     at the next SIL (graceful degradation outside the lexicon — the
//     capability the upstream WFST grammar provides via its phone loop),
//   * batched decoding: OpenMP over utterances (`ctcb_decode_batch`).
//
// Semantics are defined by (and tested against) the Python oracle in
// neural_speech_decoder_tpu_torch/decoding/beam.py.
//
// Build: decoding/lm_decoder.py compiles it at first use with
// `g++ -O3 -std=c++17 -fPIC -fopenmp -shared` into the package's _build/
// directory and loads it via ctypes.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <numeric>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr double kNegInf = -1e30;
constexpr int kBlank = 0;
constexpr int kSil = 40;

const char* kPhones[] = {
    "AA", "AE", "AH", "AO", "AW", "AY", "B",  "CH", "D",  "DH",
    "EH", "ER", "EY", "F",  "G",  "HH", "IH", "IY", "JH", "K",
    "L",  "M",  "N",  "NG", "OW", "OY", "P",  "R",  "S",  "SH",
    "T",  "TH", "UH", "UW", "V",  "W",  "Y",  "Z",  "ZH", "SIL"};

double LogSum(double a, double b) {
  if (a < b) std::swap(a, b);
  if (b <= kNegInf) return a;
  return a + std::log1p(std::exp(b - a));
}

int PhoneId(const std::string& p) {  // framework convention: +1, 0 = blank
  for (int i = 0; i < 40; ++i)
    if (p == kPhones[i]) return i + 1;
  return -1;
}

// ---------------------------------------------------------------- lexicon --
struct TrieNode {
  std::unordered_map<int, int> next;  // phone id -> node index
  std::vector<int> words;             // word ids completing here
};

struct Lexicon {
  std::vector<TrieNode> nodes{1};  // 0 = root
  std::vector<std::string> words;
  std::unordered_map<std::string, int> word_ids;

  void Add(const std::string& word, const std::vector<int>& phones) {
    auto it = word_ids.find(word);
    int wid;
    if (it == word_ids.end()) {
      wid = static_cast<int>(words.size());
      words.push_back(word);
      word_ids[word] = wid;
    } else {
      wid = it->second;
    }
    int node = 0;
    for (int p : phones) {
      auto child = nodes[node].next.find(p);
      if (child == nodes[node].next.end()) {
        nodes[node].next[p] = static_cast<int>(nodes.size());
        node = static_cast<int>(nodes.size());
        nodes.emplace_back();
      } else {
        node = child->second;
      }
    }
    auto& w = nodes[node].words;
    if (std::find(w.begin(), w.end(), wid) == w.end()) w.push_back(wid);
  }

  bool Load(const std::string& path) {
    std::ifstream f(path);
    if (!f) return false;
    std::string line;
    while (std::getline(f, line)) {
      if (line.empty() || line.rfind(";;;", 0) == 0) continue;
      std::istringstream ss(line);
      std::string word, tok;
      ss >> word;
      // strip CMUdict "(2)" alternates; lowercase
      auto paren = word.find('(');
      if (paren != std::string::npos) word = word.substr(0, paren);
      for (auto& c : word) c = std::tolower(static_cast<unsigned char>(c));
      std::vector<int> phones;
      bool all_known = true;  // skip entries with out-of-set phones: a
      // truncated pronunciation would decode the word on the wrong
      // phone sequence (mirrors the Python oracle, lexicon.py)
      while (ss >> tok) {
        std::string p;
        for (char c : tok)
          if (!std::isdigit(static_cast<unsigned char>(c)))
            p += std::toupper(static_cast<unsigned char>(c));
        int id = PhoneId(p);
        if (id > 0) phones.push_back(id);
        else all_known = false;
      }
      if (all_known && !phones.empty()) Add(word, phones);
    }
    return true;
  }
};

// --------------------------------------------------------------------- LM --
struct NgramKeyHash {
  size_t operator()(const std::vector<int>& v) const {
    uint64_t h = 1469598103934665603ull;
    for (int x : v) {
      h ^= static_cast<uint64_t>(x) + 0x9e3779b97f4a7c15ull;
      h *= 1099511628211ull;
    }
    return static_cast<size_t>(h);
  }
};

struct ArpaLM {
  int order = 0;
  std::unordered_map<std::string, int> vocab;
  std::unordered_map<std::vector<int>, std::pair<float, float>, NgramKeyHash>
      grams;
  int bos = -1, eos = -1, unk = -1;

  int WordId(const std::string& w) const {
    auto it = vocab.find(w);
    if (it != vocab.end()) return it->second;
    return unk;
  }

  bool Load(const std::string& path) {
    std::ifstream f(path);
    if (!f) return false;
    const double ln10 = std::log(10.0);
    std::string line;
    int section = 0;
    while (std::getline(f, line)) {
      while (!line.empty() && (line.back() == '\r' || line.back() == '\n'))
        line.pop_back();
      if (line.empty()) continue;
      if (line[0] == '\\') {
        int n = 0;
        if (std::sscanf(line.c_str(), "\\%d-grams:", &n) == 1) {
          section = n;
          order = std::max(order, n);
        } else {
          section = (line == "\\end\\") ? 0 : section;
          if (line == "\\data\\") section = 0;
        }
        continue;
      }
      if (section == 0) continue;
      std::istringstream ss(line);
      double logp;
      if (!(ss >> logp)) continue;
      std::vector<int> ids;
      ids.reserve(section);
      std::string w;
      for (int i = 0; i < section; ++i) {
        if (!(ss >> w)) break;
        auto it = vocab.find(w);
        int id;
        if (it == vocab.end()) {
          id = static_cast<int>(vocab.size());
          vocab[w] = id;
        } else {
          id = it->second;
        }
        ids.push_back(id);
      }
      double backoff = 0.0;
      ss >> backoff;  // optional
      grams[ids] = {static_cast<float>(logp * ln10),
                    static_cast<float>(backoff * ln10)};
    }
    auto get = [&](const char* w) {
      auto it = vocab.find(w);
      return it == vocab.end() ? -1 : it->second;
    };
    bos = get("<s>");
    eos = get("</s>");
    unk = get("<unk>");
    return true;
  }

  // For histories already trimmed to the last (order-1) ids (HistCache
  // maintains that invariant; an untrimmed Score() variant was removed as
  // dead code — re-trim at the call site if one is ever needed).
  double ScoreTrimmed(const std::vector<int>& h, int word) const {
    if (word < 0) return std::log(1e-10);
    return ScoreBackoff(h, word);
  }

  double ScoreBackoff(std::vector<int> h, int word) const {
    double acc = 0.0;
    for (;;) {
      std::vector<int> key = h;
      key.push_back(word);
      auto it = grams.find(key);
      if (it != grams.end()) return acc + it->second.first;
      if (h.empty()) return acc + std::log(1e-10);
      auto bo = grams.find(h);
      acc += (bo != grams.end()) ? bo->second.second : 0.0;
      h.erase(h.begin());
    }
  }
};

// ---------------------------------------------------------------- decoder --
struct ChainNode {  // hash-consed sequence arena (phones / words)
  int parent;       // -1 = empty sequence
  int value;
};

struct Arena {
  std::vector<ChainNode> nodes;
  std::unordered_map<uint64_t, int> dedup;

  int Extend(int parent, int value) {
    uint64_t key = (static_cast<uint64_t>(static_cast<uint32_t>(parent)) << 32) |
                   static_cast<uint32_t>(value);
    auto it = dedup.find(key);
    if (it != dedup.end()) return it->second;
    int idx = static_cast<int>(nodes.size());
    nodes.push_back({parent, value});
    dedup[key] = idx;
    return idx;
  }

  std::vector<int> Materialize(int node) const {
    std::vector<int> out;
    for (int n = node; n >= 0; n = nodes[n].parent) out.push_back(nodes[n].value);
    std::reverse(out.begin(), out.end());
    return out;
  }

};

// trie field values: >=0 = lexicon trie node (0 root); -1 = no lexicon;
// -2 = OOV free-phone track (inside an out-of-lexicon word).
constexpr int kTrieFree = -2;

struct State {
  int phones = -1;  // arena node
  int words = -1;   // arena node
  int trie = 0;
  int last = -1;    // last phone id (-1 none)
  double lm = 0.0;
  double pen = 0.0;  // accumulated lm_weight-independent penalties (OOV)
  double p_b = kNegInf, p_nb = kNegInf;

  double Total() const { return LogSum(p_b, p_nb); }
};

struct StateKeyHash {
  size_t operator()(const std::tuple<int, int, int>& k) const {
    auto [a, b, c] = k;
    uint64_t h = static_cast<uint32_t>(a);
    h = h * 1000003 + static_cast<uint32_t>(b);
    h = h * 1000003 + static_cast<uint32_t>(c);
    return static_cast<size_t>(h);
  }
};

constexpr float kOovDisabled = 1e30f;

struct Decoder {
  Lexicon lexicon;
  ArpaLM lm;
  bool has_lexicon = false, has_lm = false;
  float acoustic_scale = 0.5f;
  int nbest = 100;
  float beam = 18.0f;
  int max_active = 200;
  float lm_weight = 1.0f;
  float word_ins_penalty = 0.0f;
  int top_k_tokens = 12;
  // Additive per-phone score delta inside an OOV word (negative penalizes;
  // kOovDisabled turns the fallback track off entirely).
  float oov_cost = kOovDisabled;
  int unk_wid = -1;  // lexicon word id of "<unk>" when OOV is enabled
  // Word-boundary-free decoding: words may also commit eagerly at any
  // word-end trie node when the next phone starts a new word — required
  // for models/lexicons without SIL word delimiters (the upstream WFST's
  // TLG composition handles this via epsilon word arcs).
  bool boundary_free = false;
  // lexicon word id -> LM vocab id, precomputed at create (avoids string
  // hashing on every LM score call — the decode hot path).
  std::vector<int> lex2lm;

  bool OovEnabled() const { return oov_cost < kOovDisabled; }

  void BuildLex2Lm() {
    lex2lm.resize(lexicon.words.size());
    for (size_t i = 0; i < lexicon.words.size(); ++i)
      lex2lm[i] = has_lm ? lm.WordId(lexicon.words[i]) : -1;
  }

  double Combined(const State& s, int n_words) const {
    return s.Total() + lm_weight * s.lm + word_ins_penalty * n_words + s.pen;
  }

  // Per-decode incremental LM-history cache: maps a words-arena node to the
  // last (order-1) LM word ids of its history (BOS-prefixed). Arena ids are
  // dense and append-only, so a flat vector indexed by node+1 works; entry
  // 0 is the empty history.
  struct HistCache {
    std::vector<std::vector<int>> hist;  // index: words_node + 1
    // Explicit computed flags: an EMPTY entry is a legitimate history
    // (no-BOS LMs, order<=1), so emptiness cannot double as the
    // "not computed" sentinel — with the old sentinel, a first query for
    // a non-root node would resize hist and then early-return the
    // still-uncomputed (empty) BOS entry from the recursion, silently
    // dropping <s> from every LM score in the session.
    std::vector<char> valid;
    const Decoder* d;
    const Arena* arena;

    const std::vector<int>& Get(int node) {
      size_t idx = static_cast<size_t>(node + 1);
      if (idx < valid.size() && valid[idx]) return hist[idx];
      if (hist.size() <= idx) {
        hist.resize(arena->nodes.size() + 1);
        valid.resize(hist.size(), 0);
      }
      if (node < 0) {
        if (d->lm.bos >= 0) hist[0] = {d->lm.bos};
        valid[0] = 1;
        return hist[0];
      }
      const ChainNode& cn = arena->nodes[node];
      std::vector<int> h = Get(cn.parent);  // copy
      h.push_back(d->lex2lm[cn.value]);
      int keep = d->lm.order > 1 ? d->lm.order - 1 : 0;
      if (static_cast<int>(h.size()) > keep)
        h.erase(h.begin(), h.end() - keep);
      if (hist.size() <= idx) {
        hist.resize(idx + 1);
        valid.resize(hist.size(), 0);
      }
      hist[idx] = std::move(h);
      valid[idx] = 1;
      return hist[idx];
    }
  };

  struct Hyp {
    std::vector<int> phones;
    std::vector<int> words;
    double score, ac, lm;
  };

  using Key = std::tuple<int, int, int>;

  // All per-decode mutable state, separable from the (shared, read-only)
  // decoder: offline Decode() is StartSession + one Feed + Finalize, and
  // the streaming C API feeds chunks into a long-lived Session — one code
  // path, so the offline parity tests cover the streaming internals.
  struct Session {
    Arena phones_arena, words_arena;
    HistCache hc;
    std::unordered_map<Key, State, StateKeyHash> states;
  };

  // NOTE: fills in place (the HistCache holds a pointer to the session's
  // own words arena, so a Session must never be copied/moved after init).
  void InitSession(Session& ses) const {
    ses.hc = HistCache{{}, {}, this, &ses.words_arena};
    State init;
    init.p_b = 0.0;
    init.trie = has_lexicon ? 0 : -1;
    ses.states[{-1, -1, init.trie}] = init;
  }

  // Advance the beam by T frames. Safe to call repeatedly (chunked).
  void Feed(Session& ses, const float* logprobs, int T, int K,
            float blank_penalty) const {
    Arena& phones_arena = ses.phones_arena;
    Arena& words_arena = ses.words_arena;
    HistCache& hc = ses.hc;
    auto& states = ses.states;

    std::vector<double> frame(K);
    std::vector<int> order(K);
    std::vector<std::pair<double, const State*>> ranked;

    for (int t = 0; t < T; ++t) {
      for (int k = 0; k < K; ++k) {
        frame[k] = static_cast<double>(logprobs[t * K + k]) * acoustic_scale;
      }
      frame[kBlank] -= blank_penalty;
      // top-k tokens
      std::iota(order.begin(), order.end(), 0);
      int kk = std::min(top_k_tokens, K);
      std::partial_sort(order.begin(), order.begin() + kk, order.end(),
                        [&](int a, int b) { return frame[a] > frame[b]; });

      std::unordered_map<Key, State, StateKeyHash> next;
      auto upd = [&](int phn, int wrd, int trie, int last, double lmsc,
                     double pen, double pb, double pnb) {
        Key key{phn, wrd, trie};
        auto it = next.find(key);
        if (it == next.end()) {
          State s;
          s.phones = phn;
          s.words = wrd;
          s.trie = trie;
          s.last = last;
          s.lm = lmsc;
          s.pen = pen;
          s.p_b = pb;
          s.p_nb = pnb;
          next[key] = s;
        } else {
          it->second.p_b = LogSum(it->second.p_b, pb);
          it->second.p_nb = LogSum(it->second.p_nb, pnb);
        }
      };

      for (auto& [key, s] : states) {
        double tot = s.Total();
        // 1. blank
        upd(s.phones, s.words, s.trie, s.last, s.lm, s.pen,
            tot + frame[kBlank], kNegInf);
        for (int ci = 0; ci < kk; ++ci) {
          int c = order[ci];
          if (c == kBlank) continue;
          double src;
          if (c == s.last) {
            // 2. repeat (same prefix)
            upd(s.phones, s.words, s.trie, s.last, s.lm, s.pen, kNegInf,
                s.p_nb + frame[c]);
            src = s.p_b;
          } else {
            src = tot;
          }
          if (src <= kNegInf) continue;
          // 3. extension
          if (!has_lexicon) {
            int pn = phones_arena.Extend(s.phones, c);
            upd(pn, s.words, -1, c, s.lm, s.pen, kNegInf, src + frame[c]);
            continue;
          }
          if (c == kSil) {
            if (s.trie == 0) {
              int pn = phones_arena.Extend(s.phones, c);
              upd(pn, s.words, 0, c, s.lm, s.pen, kNegInf, src + frame[c]);
            } else if (s.trie == kTrieFree) {
              // OOV word ends: commit <unk>
              int pn = phones_arena.Extend(s.phones, c);
              double lm_inc =
                  has_lm ? lm.ScoreTrimmed(hc.Get(s.words), lm.unk) : 0.0;
              int wn = words_arena.Extend(s.words, unk_wid);
              upd(pn, wn, 0, c, s.lm + lm_inc, s.pen, kNegInf,
                  src + frame[c]);
            } else if (!lexicon.nodes[s.trie].words.empty()) {
              int pn = phones_arena.Extend(s.phones, c);
              for (int wid : lexicon.nodes[s.trie].words) {
                double lm_inc = 0.0;
                if (has_lm) {
                  lm_inc = lm.ScoreTrimmed(hc.Get(s.words), lex2lm[wid]);
                }
                int wn = words_arena.Extend(s.words, wid);
                upd(pn, wn, 0, c, s.lm + lm_inc, s.pen, kNegInf,
                    src + frame[c]);
              }
            }
            // mid-word SIL with no completed word: disallowed
          } else {
            if (s.trie == kTrieFree) {
              // continue the OOV word with any phone
              int pn = phones_arena.Extend(s.phones, c);
              upd(pn, s.words, kTrieFree, c, s.lm, s.pen + oov_cost, kNegInf,
                  src + frame[c]);
            } else {
              auto child = lexicon.nodes[s.trie].next.find(c);
              if (child != lexicon.nodes[s.trie].next.end()) {
                int pn = phones_arena.Extend(s.phones, c);
                upd(pn, s.words, child->second, c, s.lm, s.pen, kNegInf,
                    src + frame[c]);
              }
              if (boundary_free && s.trie != 0 &&
                  !lexicon.nodes[s.trie].words.empty()) {
                // eager commit: end the current word here and start a new
                // one with phone c (no SIL delimiter between them)
                auto root_child = lexicon.nodes[0].next.find(c);
                if (root_child != lexicon.nodes[0].next.end()) {
                  int pn = phones_arena.Extend(s.phones, c);
                  for (int wid : lexicon.nodes[s.trie].words) {
                    double lm_inc =
                        has_lm
                            ? lm.ScoreTrimmed(hc.Get(s.words), lex2lm[wid])
                            : 0.0;
                    int wn = words_arena.Extend(s.words, wid);
                    upd(pn, wn, root_child->second, c, s.lm + lm_inc, s.pen,
                        kNegInf, src + frame[c]);
                  }
                }
              }
              if (OovEnabled() && s.trie == 0) {
                // start an OOV word (parallel free-phone track from the
                // word boundary)
                int pn = phones_arena.Extend(s.phones, c);
                upd(pn, s.words, kTrieFree, c, s.lm, s.pen + oov_cost,
                    kNegInf, src + frame[c]);
              }
            }
          }
        }
      }

      // prune: score beam + max_active
      ranked.clear();
      ranked.reserve(next.size());
      for (auto& [key, s] : next) {
        int nw = 0;
        for (int n = s.words; n >= 0; n = words_arena.nodes[n].parent) ++nw;
        ranked.emplace_back(Combined(s, nw), &s);
      }
      std::sort(ranked.begin(), ranked.end(),
                [](const auto& a, const auto& b) { return a.first > b.first; });
      double best = ranked.empty() ? 0.0 : ranked.front().first;
      states.clear();
      int kept = 0;
      for (auto& [score, sp] : ranked) {
        if (score <= best - beam || kept >= max_active) break;
        states[{sp->phones, sp->words, sp->trie}] = *sp;
        ++kept;
      }
    }
  }

  // Rank the current beam into n-best hypotheses. Non-destructive w.r.t.
  // the beam itself (the LM-history cache warms up, which is fine), so a
  // streaming consumer can peek partial results mid-utterance.
  std::vector<Hyp> Finalize(Session& ses) const {
    Arena& phones_arena = ses.phones_arena;
    Arena& words_arena = ses.words_arena;
    HistCache& hc = ses.hc;
    auto& states = ses.states;
    std::vector<Hyp> finals;
    for (auto& [key, s] : states) {
      std::vector<State> cands;
      if (!has_lexicon || s.trie == 0) {
        cands.push_back(s);
      } else if (s.trie == kTrieFree) {
        // trailing OOV word: commit <unk> without a final SIL
        State c = s;
        double lm_inc =
            has_lm ? lm.ScoreTrimmed(hc.Get(s.words), lm.unk) : 0.0;
        c.words = words_arena.Extend(s.words, unk_wid);
        c.trie = 0;
        c.lm = s.lm + lm_inc;
        cands.push_back(c);
      } else if (!lexicon.nodes[s.trie].words.empty()) {
        for (int wid : lexicon.nodes[s.trie].words) {
          State c = s;
          double lm_inc = 0.0;
          if (has_lm)
            lm_inc = lm.ScoreTrimmed(hc.Get(s.words), lex2lm[wid]);
          c.words = words_arena.Extend(s.words, wid);
          c.trie = 0;
          c.lm = s.lm + lm_inc;
          cands.push_back(c);
        }
      } else {
        continue;  // incomplete word
      }
      for (auto& c : cands) {
        double lm_total = c.lm;
        if (has_lm && lm.eos >= 0)
          lm_total += lm.ScoreTrimmed(hc.Get(c.words), lm.eos);
        double ac = c.Total();
        std::vector<int> wids = words_arena.Materialize(c.words);
        double score = ac + lm_weight * lm_total +
                       word_ins_penalty * static_cast<double>(wids.size()) +
                       c.pen;
        finals.push_back(
            {phones_arena.Materialize(c.phones), wids, score, ac, lm_total});
      }
    }
    // Deterministic tie-break (matches the Python oracle): equal-scored
    // hypotheses (e.g. homophone orderings under a unigram LM) rank by
    // phones then word strings.
    auto words_less = [this](const std::vector<int>& a,
                             const std::vector<int>& b) {
      size_t n = std::min(a.size(), b.size());
      for (size_t i = 0; i < n; ++i) {
        const std::string& wa = lexicon.words[a[i]];
        const std::string& wb = lexicon.words[b[i]];
        if (wa != wb) return wa < wb;
      }
      return a.size() < b.size();
    };
    std::sort(finals.begin(), finals.end(),
              [&](const Hyp& a, const Hyp& b) {
                if (a.score != b.score) return a.score > b.score;
                if (a.phones != b.phones) return a.phones < b.phones;
                return words_less(a.words, b.words);
              });
    // dedup identical (phones, words)
    std::vector<Hyp> out;
    for (auto& h : finals) {
      bool dup = false;
      for (auto& o : out)
        if (o.phones == h.phones && o.words == h.words) {
          dup = true;
          break;
        }
      if (!dup) out.push_back(std::move(h));
      if (static_cast<int>(out.size()) >= nbest) break;
    }
    return out;
  }

  // const + session-local arenas: safe to call concurrently from many
  // threads on the same (shared, read-only) lexicon/LM.
  std::vector<Hyp> Decode(const float* logprobs, int T, int K,
                          float blank_penalty) const {
    Session ses;
    InitSession(ses);
    Feed(ses, logprobs, T, K, blank_penalty);
    return Finalize(ses);
  }
};

// Shared hypothesis write-out. Returns count, or -2 on words overflow.
int WriteHyps(const Decoder& d, const std::vector<Decoder::Hyp>& hyps,
              int phones_stride, int32_t* out_phones, int32_t* out_phone_lens,
              char* out_words, int words_buf, float* out_scores,
              float* out_ac, float* out_lm) {
  int n = static_cast<int>(hyps.size());
  int wpos = 0;
  for (int i = 0; i < n; ++i) {
    const auto& h = hyps[i];
    out_phone_lens[i] = static_cast<int32_t>(h.phones.size());
    for (size_t j = 0;
         j < h.phones.size() && j < static_cast<size_t>(phones_stride); ++j)
      out_phones[i * phones_stride + j] = h.phones[j];
    out_scores[i] = static_cast<float>(h.score);
    out_ac[i] = static_cast<float>(h.ac);
    out_lm[i] = static_cast<float>(h.lm);
    std::string joined;
    for (size_t j = 0; j < h.words.size(); ++j) {
      if (j) joined += '\n';
      joined += d.lexicon.words[h.words[j]];
    }
    joined += '\x1e';
    if (wpos + static_cast<int>(joined.size()) >= words_buf) return -2;
    std::memcpy(out_words + wpos, joined.data(), joined.size());
    wpos += static_cast<int>(joined.size());
  }
  if (wpos < words_buf) out_words[wpos] = '\0';
  return n;
}

}  // namespace

// ------------------------------------------------------------------ C API --
extern "C" {

// Bumped whenever the C ABI changes (ctcb_create signature, session API,
// output formats). The Python wrapper refuses to load a library whose
// version does not match, falling back to the Python engine instead of
// calling through a stale prebuilt .so with the wrong signatures.
int ctcb_abi_version(void) { return 3; }

void* ctcb_create(const char* lexicon_path, const char* arpa_path,
                  float acoustic_scale, int nbest, float beam, int max_active,
                  float lm_weight, float word_ins_penalty, int top_k_tokens,
                  float oov_cost, int boundary_free) {
  auto* d = new Decoder();
  d->acoustic_scale = acoustic_scale;
  d->nbest = nbest;
  d->beam = beam;
  d->max_active = max_active;
  d->lm_weight = lm_weight;
  d->word_ins_penalty = word_ins_penalty;
  d->top_k_tokens = top_k_tokens;
  d->oov_cost = oov_cost;
  d->boundary_free = boundary_free != 0;
  if (lexicon_path && lexicon_path[0]) {
    if (!d->lexicon.Load(lexicon_path)) {
      delete d;
      return nullptr;
    }
    d->has_lexicon = true;
  }
  if (arpa_path && arpa_path[0]) {
    if (!d->lm.Load(arpa_path)) {
      delete d;
      return nullptr;
    }
    d->has_lm = true;
  }
  if (d->OovEnabled() && d->has_lexicon) {
    auto it = d->lexicon.word_ids.find("<unk>");
    if (it == d->lexicon.word_ids.end()) {
      d->unk_wid = static_cast<int>(d->lexicon.words.size());
      d->lexicon.words.push_back("<unk>");
      d->lexicon.word_ids["<unk>"] = d->unk_wid;
    } else {
      d->unk_wid = it->second;
    }
  }
  d->BuildLex2Lm();
  return d;
}

// Returns number of hypotheses written, or -1 on error.
// out_phones: [nbest * T] int32 (phone ids per hyp, padded with 0)
// out_phone_lens: [nbest]
// out_words: '\n'-separated words per hyp, hyps separated by '\x1e'
// out_scores/out_ac/out_lm: [nbest]
int ctcb_decode(void* handle, const float* logprobs, int T, int K,
                float blank_penalty, int32_t* out_phones,
                int32_t* out_phone_lens, char* out_words, int words_buf,
                float* out_scores, float* out_ac, float* out_lm) {
  if (!handle) return -1;
  auto* d = static_cast<Decoder*>(handle);
  auto hyps = d->Decode(logprobs, T, K, blank_penalty);
  return WriteHyps(*d, hyps, T, out_phones, out_phone_lens, out_words,
                   words_buf, out_scores, out_ac, out_lm);
}

// Batched decode: N utterances, padded to T_max frames; t_lens[i] gives the
// real frame count. OpenMP-parallel over utterances (the decoder object is
// read-only during decode). Per-utterance outputs are strided:
//   out_phones:      [N, nbest, T_max]
//   out_phone_lens:  [N, nbest]
//   out_counts:      [N]   (hyp count, or -2 on words-buffer overflow)
//   out_words:       [N, words_stride] bytes
//   out_scores/ac/lm:[N, nbest]
// Returns 0, or -1 on bad args.
int ctcb_decode_batch(void* handle, const float* logprobs,
                      const int32_t* t_lens, int N, int T_max, int K,
                      float blank_penalty, int n_threads, int32_t* out_phones,
                      int32_t* out_phone_lens, int32_t* out_counts,
                      char* out_words, int words_stride, float* out_scores,
                      float* out_ac, float* out_lm) {
  if (!handle || N < 0) return -1;
  auto* d = static_cast<Decoder*>(handle);
  const int nb = d->nbest;
#ifdef _OPENMP
  if (n_threads <= 0) n_threads = omp_get_max_threads();
#pragma omp parallel for num_threads(n_threads) schedule(dynamic, 1)
#endif
  for (int i = 0; i < N; ++i) {
    int t = t_lens ? t_lens[i] : T_max;
    if (t > T_max) t = T_max;
    auto hyps = d->Decode(logprobs + static_cast<int64_t>(i) * T_max * K, t,
                          K, blank_penalty);
    out_counts[i] = WriteHyps(
        *d, hyps, T_max, out_phones + static_cast<int64_t>(i) * nb * T_max,
        out_phone_lens + static_cast<int64_t>(i) * nb,
        out_words + static_cast<int64_t>(i) * words_stride, words_stride,
        out_scores + static_cast<int64_t>(i) * nb,
        out_ac + static_cast<int64_t>(i) * nb,
        out_lm + static_cast<int64_t>(i) * nb);
  }
  return 0;
}

void ctcb_free(void* handle) { delete static_cast<Decoder*>(handle); }

// --- streaming session API -------------------------------------------------
// One utterance per session: feed log-prob chunks as the model emits them;
// read the current n-best at any point (partial results) without
// disturbing the beam. The upstream real-time WFST decoders work the same
// way; the offline ctcb_decode is exactly start + one feed + nbest.

struct SessionHandle {
  const Decoder* d;
  Decoder::Session ses;
};

void* ctcb_session_start(void* handle) {
  if (!handle) return nullptr;
  auto* d = static_cast<Decoder*>(handle);
  auto* w = new SessionHandle();
  w->d = d;
  d->InitSession(w->ses);
  return w;
}

// Advance the beam by T frames. Returns 0, or -1 on bad args.
int ctcb_session_feed(void* sess, const float* logprobs, int T, int K,
                      float blank_penalty) {
  auto* w = static_cast<SessionHandle*>(sess);
  if (!w || T < 0 || K <= 0) return -1;
  w->d->Feed(w->ses, logprobs, T, K, blank_penalty);
  return 0;
}

// Current n-best (same output format as ctcb_decode; phones_stride is the
// caller's per-hypothesis phone-buffer capacity). Returns the hypothesis
// count, -2 on words overflow, -3 if a hypothesis exceeds phones_stride.
int ctcb_session_nbest(void* sess, int phones_stride, int32_t* out_phones,
                       int32_t* out_phone_lens, char* out_words,
                       int words_buf, float* out_scores, float* out_ac,
                       float* out_lm) {
  auto* w = static_cast<SessionHandle*>(sess);
  if (!w) return -1;
  auto hyps = w->d->Finalize(w->ses);
  for (const auto& h : hyps)
    if (static_cast<int>(h.phones.size()) > phones_stride) return -3;
  return WriteHyps(*w->d, hyps, phones_stride, out_phones, out_phone_lens,
                   out_words, words_buf, out_scores, out_ac, out_lm);
}

void ctcb_session_free(void* sess) {
  delete static_cast<SessionHandle*>(sess);
}

}  // extern "C"
