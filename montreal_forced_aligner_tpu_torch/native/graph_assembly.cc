// Host graph-assembly core for monophone alignment graphs.
//
// Replaces the Python-side template splicing + junction-arc bookkeeping of
// AlignmentGraphCompiler.compile (graph/compiler.py) for context-independent
// (N=1) trees — the per-utterance host stage that scales linearly with corpus
// size (reference equivalent: the compile-train-graphs workers,
// alignment/multiprocessing.py:386). Semantics and *ordering* replicate the
// Python compiler exactly (state/instance/arc insertion order determines
// argmax tie-breaking in the Viterbi DP, hence boundaries), verified
// bit-exactly by tests/test_torch_native_graph.py.
//
// The Python side (graph/native_compile.py) passes:
//   - a frozen template table (states, arcs, branch metadata) shared by the
//     Python compiler's own cache, and
//   - a per-utterance "program": per word, the variant list (template id,
//     pronunciation cost, silence log-probs, last phone).
// This file replays the expansion: optional initial silence, per-word
// pronunciation variants connected from the frontier, optional silence after
// each word (one instance per distinct variant-final phone), and the final
// "finish" step (stable counting sort of arcs by destination into dense
// (S, K) incoming-arc arrays).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr double kNegInf = -1.0e30;

struct TemplateTable {
  int32_t nt;
  const int32_t* n_states;
  const int32_t* n_inst;
  const int32_t* state_off;  // NT+1 prefix offsets into state arrays
  const int32_t* pdf;
  const int32_t* tstate;
  const int32_t* hmm;
  const int32_t* phone;
  const int32_t* word_rel;  // <0 -> silence state (word column forced -1)
  const int32_t* inst_rel;
  const int32_t* arc_off;  // NT+1 prefix offsets into arc arrays
  const int32_t* arc_src;
  const int32_t* arc_dst;
  const float* arc_w;
  const int32_t* arc_tid;
  const int32_t* branch_off;  // NT+1 prefix offsets into branch arrays
  const int32_t* br_entry;    // per branch, relative entry state
  const int32_t* br_lset_off;  // NB+1; empty range -> matches every left
  const int32_t* br_lset;
  const int32_t* br_exit_off;  // NB+1
  const int32_t* br_exit_state;
  const double* br_exit_w;
  const int32_t* br_exit_tid;
};

struct Program {
  int32_t n_utts;
  const int32_t* utt_word_off;  // n_utts+1
  const int32_t* word_var_off;  // total_words+1
  const int32_t* var_tpl;       // per variant
  const double* var_cost;       // pronunciation cost (subtracted)
  const double* var_log_psil;
  const double* var_log_1m_psil;
  const int32_t* var_last_phone;
  int32_t sil_tpl;
  int32_t sil_phone;
  double log_p_init;
  double log_1m_p_init;
  double sil_corr;
  double nonsil_corr;
};

struct Graph {
  int32_t S = 0;
  int32_t K = 0;
  std::vector<int32_t> pdf, tstate, hmm, phone, word, instance;
  std::vector<int32_t> in_src, in_tid;
  std::vector<float> in_weight;
  std::vector<float> start, final_w;
  std::vector<int32_t> final_tid;
};

struct Frontier {
  int32_t src;  // -1 -> "start" pseudo-source
  double w;
  int32_t tid;
  int32_t l;  // left-context phone carried forward
};

struct Builder {
  const TemplateTable& T;
  int32_t num_states = 0;
  int32_t num_inst = 0;
  std::vector<int32_t> splice_tpl, splice_word, splice_base, splice_ibase;
  // junction arcs, in insertion order
  std::vector<int32_t> jsrc, jdst, jtid;
  std::vector<double> jw;
  // start/final as sparse (state, value) with replicate-exact merge rules
  std::vector<int32_t> start_state;
  std::vector<double> start_w;
  std::vector<int32_t> final_state, final_tid;
  std::vector<double> final_w;

  explicit Builder(const TemplateTable& t) : T(t) {}

  int32_t splice(int32_t tpl, int32_t word) {
    int32_t base = num_states;
    splice_tpl.push_back(tpl);
    splice_word.push_back(word);
    splice_base.push_back(base);
    splice_ibase.push_back(num_inst);
    num_states += T.n_states[tpl];
    num_inst += T.n_inst[tpl];
    return base;
  }

  void add_arc(int32_t src, int32_t dst, double w, int32_t tid) {
    jsrc.push_back(src);
    jdst.push_back(dst);
    jw.push_back(w);
    jtid.push_back(tid);
  }

  void add_start(int32_t state, double w) {
    for (size_t i = 0; i < start_state.size(); ++i) {
      if (start_state[i] == state) {
        if (w > start_w[i]) start_w[i] = w;  // max-merge (compiler.py:179)
        return;
      }
    }
    start_state.push_back(state);
    start_w.push_back(w);
  }

  void add_final(int32_t state, double w, int32_t tid) {
    for (size_t i = 0; i < final_state.size(); ++i) {
      if (final_state[i] == state) {
        // keep-max (compiler.py:183); a stored kNegInf counts as unset so
        // the Python path's tid-overwrite behavior is matched exactly
        if (final_w[i] > kNegInf && final_w[i] >= w) return;
        final_w[i] = w;
        final_tid[i] = tid;
        return;
      }
    }
    final_state.push_back(state);
    final_w.push_back(w);
    final_tid.push_back(tid);
  }

  void finish(Graph* out) const {
    const int32_t S = num_states;
    out->S = S;
    // state label columns, one template block at a time
    out->pdf.resize(S);
    out->tstate.resize(S);
    out->hmm.resize(S);
    out->phone.resize(S);
    out->word.resize(S);
    out->instance.resize(S);
    for (size_t sp = 0; sp < splice_tpl.size(); ++sp) {
      const int32_t t = splice_tpl[sp];
      const int32_t base = splice_base[sp];
      const int32_t ibase = splice_ibase[sp];
      const int32_t w = splice_word[sp];
      const int32_t so = T.state_off[t];
      const int32_t n = T.n_states[t];
      std::memcpy(out->pdf.data() + base, T.pdf + so, n * sizeof(int32_t));
      std::memcpy(out->tstate.data() + base, T.tstate + so, n * sizeof(int32_t));
      std::memcpy(out->hmm.data() + base, T.hmm + so, n * sizeof(int32_t));
      std::memcpy(out->phone.data() + base, T.phone + so, n * sizeof(int32_t));
      for (int32_t j = 0; j < n; ++j) {
        out->word[base + j] = T.word_rel[so + j] < 0 ? -1 : w;
        out->instance[base + j] = T.inst_rel[so + j] + ibase;
      }
    }
    // concatenated arc order = template blocks (splice order), then junction
    // arcs (insertion order) — matches _GraphBuilder.finish, whose stable
    // argsort by destination preserves it within each destination.
    size_t n_arcs = jsrc.size();
    for (int32_t t : splice_tpl) n_arcs += T.arc_off[t + 1] - T.arc_off[t];
    std::vector<int32_t> counts(S, 0);
    for (size_t sp = 0; sp < splice_tpl.size(); ++sp) {
      const int32_t t = splice_tpl[sp];
      const int32_t base = splice_base[sp];
      for (int32_t a = T.arc_off[t]; a < T.arc_off[t + 1]; ++a)
        counts[T.arc_dst[a] + base]++;
    }
    for (int32_t d : jdst) counts[d]++;
    int32_t K = 1;
    for (int32_t c : counts)
      if (c > K) K = c;
    out->K = K;
    out->in_src.assign((size_t)S * K, 0);
    out->in_tid.assign((size_t)S * K, 0);
    out->in_weight.assign((size_t)S * K, (float)kNegInf);
    std::vector<int32_t> fill(S, 0);
    auto put = [&](int32_t src, int32_t dst, float w, int32_t tid) {
      const size_t slot = (size_t)dst * K + fill[dst]++;
      out->in_src[slot] = src;
      out->in_weight[slot] = w;
      out->in_tid[slot] = tid;
    };
    for (size_t sp = 0; sp < splice_tpl.size(); ++sp) {
      const int32_t t = splice_tpl[sp];
      const int32_t base = splice_base[sp];
      for (int32_t a = T.arc_off[t]; a < T.arc_off[t + 1]; ++a)
        put(T.arc_src[a] + base, T.arc_dst[a] + base, T.arc_w[a],
            T.arc_tid[a]);
    }
    for (size_t a = 0; a < jsrc.size(); ++a)
      put(jsrc[a], jdst[a], (float)jw[a], jtid[a]);
    out->start.assign(S, (float)kNegInf);
    out->final_w.assign(S, (float)kNegInf);
    out->final_tid.assign(S, 0);
    for (size_t i = 0; i < start_state.size(); ++i)
      out->start[start_state[i]] = (float)start_w[i];
    for (size_t i = 0; i < final_state.size(); ++i) {
      out->final_w[final_state[i]] = (float)final_w[i];
      out->final_tid[final_state[i]] = final_tid[i];
    }
  }
};

struct BranchView {
  int32_t entry;  // absolute
  int32_t lset_begin, lset_end;  // indices into T.br_lset; equal -> ALL
  int32_t exit_begin, exit_end;  // indices into exit arrays
  int32_t base;                  // splice base for exit rebasing
};

inline bool lset_has(const TemplateTable& T, const BranchView& b, int32_t l) {
  if (b.lset_begin == b.lset_end) return true;
  for (int32_t i = b.lset_begin; i < b.lset_end; ++i)
    if (T.br_lset[i] == l) return true;
  return false;
}

void compile_one(const TemplateTable& T, const Program& P, int32_t u,
                 Graph* out) {
  Builder g(T);
  const int32_t w_begin = P.utt_word_off[u];
  const int32_t w_end = P.utt_word_off[u + 1];
  const int32_t W = w_end - w_begin;

  auto splice_branches = [&](int32_t tpl, int32_t word,
                             std::vector<BranchView>* views) {
    const int32_t base = g.splice(tpl, word);
    views->clear();
    for (int32_t b = T.branch_off[tpl]; b < T.branch_off[tpl + 1]; ++b) {
      BranchView v;
      v.entry = T.br_entry[b] + base;
      v.lset_begin = T.br_lset_off[b];
      v.lset_end = T.br_lset_off[b + 1];
      v.exit_begin = T.br_exit_off[b];
      v.exit_end = T.br_exit_off[b + 1];
      v.base = base;
      views->push_back(v);
    }
  };

  std::vector<BranchView> views;
  if (W == 0) {  // empty transcript: one silence instance (compiler.py:743)
    splice_branches(P.sil_tpl, -1, &views);
    for (const auto& v : views) {
      g.add_start(v.entry, 0.0);
      for (int32_t e = v.exit_begin; e < v.exit_end; ++e)
        g.add_final(T.br_exit_state[e] + v.base, T.br_exit_w[e],
                    T.br_exit_tid[e]);
    }
    g.finish(out);
    return;
  }

  std::vector<Frontier> frontier, new_frontier;
  frontier.push_back({-1, P.log_1m_p_init, 0, 0});
  splice_branches(P.sil_tpl, -1, &views);
  for (const auto& v : views) {
    g.add_start(v.entry, P.log_p_init);
    for (int32_t e = v.exit_begin; e < v.exit_end; ++e)
      frontier.push_back({T.br_exit_state[e] + v.base, T.br_exit_w[e],
                          T.br_exit_tid[e], P.sil_phone});
  }

  // silence-after inputs grouped by the emitting variant's final phone, in
  // first-encounter order (Python dict insertion order, compiler.py:767)
  std::vector<int32_t> sil_keys;
  std::vector<std::vector<Frontier>> sil_inputs;  // reuse Frontier as tuple

  for (int32_t wi = 0; wi < W; ++wi) {
    const bool is_last = wi == W - 1;
    new_frontier.clear();
    sil_keys.clear();
    sil_inputs.clear();
    for (int32_t vi = P.word_var_off[w_begin + wi];
         vi < P.word_var_off[w_begin + wi + 1]; ++vi) {
      const double pron_cost = P.var_cost[vi];
      const double log_psil = P.var_log_psil[vi];
      const double log_1m_psil = P.var_log_1m_psil[vi];
      const int32_t last_phone = P.var_last_phone[vi];
      splice_branches(P.var_tpl[vi], wi, &views);
      for (const auto& v : views) {
        for (const auto& f : frontier) {
          if (!lset_has(T, v, f.l)) continue;
          if (f.src < 0)
            g.add_start(v.entry, f.w - pron_cost);
          else
            g.add_arc(f.src, v.entry, f.w - pron_cost, f.tid);
        }
        for (int32_t e = v.exit_begin; e < v.exit_end; ++e) {
          const int32_t s = T.br_exit_state[e] + v.base;
          const double w = T.br_exit_w[e];
          const int32_t tid = T.br_exit_tid[e];
          // bucket for this final phone, created lazily on first append
          // (Python dict.setdefault inside the exits loop, compiler.py:792)
          size_t bucket = sil_keys.size();
          for (size_t i = 0; i < sil_keys.size(); ++i)
            if (sil_keys[i] == last_phone) {
              bucket = i;
              break;
            }
          if (bucket == sil_keys.size()) {
            sil_keys.push_back(last_phone);
            sil_inputs.emplace_back();
          }
          sil_inputs[bucket].push_back({s, w + log_psil, tid, 0});
          if (is_last)
            g.add_final(s, w + log_1m_psil + P.nonsil_corr, tid);
          else
            new_frontier.push_back({s, w + log_1m_psil, tid, last_phone});
        }
      }
    }
    // optional silence after this word, one instance per distinct left
    for (size_t b = 0; b < sil_keys.size(); ++b) {
      splice_branches(P.sil_tpl, -1, &views);
      for (const auto& v : views) {
        for (const auto& in : sil_inputs[b]) g.add_arc(in.src, v.entry, in.w, in.tid);
        for (int32_t e = v.exit_begin; e < v.exit_end; ++e) {
          const int32_t ss = T.br_exit_state[e] + v.base;
          const double sw = T.br_exit_w[e];
          const int32_t stid = T.br_exit_tid[e];
          if (is_last)
            g.add_final(ss, sw + P.sil_corr, stid);
          else
            new_frontier.push_back({ss, sw, stid, P.sil_phone});
        }
      }
    }
    frontier.swap(new_frontier);
  }
  g.finish(out);
}

struct BatchHandle {
  std::vector<Graph> graphs;
};

}  // namespace

extern "C" {

void* gac_compile_mono_batch(
    // template table
    int32_t nt, const int32_t* tpl_n_states, const int32_t* tpl_n_inst,
    const int32_t* tpl_state_off, const int32_t* tpl_pdf,
    const int32_t* tpl_tstate, const int32_t* tpl_hmm,
    const int32_t* tpl_phone, const int32_t* tpl_word_rel,
    const int32_t* tpl_inst_rel, const int32_t* tpl_arc_off,
    const int32_t* tpl_arc_src, const int32_t* tpl_arc_dst,
    const float* tpl_arc_w, const int32_t* tpl_arc_tid,
    const int32_t* tpl_branch_off, const int32_t* br_entry,
    const int32_t* br_lset_off, const int32_t* br_lset,
    const int32_t* br_exit_off, const int32_t* br_exit_state,
    const double* br_exit_w, const int32_t* br_exit_tid,
    // program
    int32_t n_utts, const int32_t* utt_word_off, const int32_t* word_var_off,
    const int32_t* var_tpl, const double* var_cost,
    const double* var_log_psil, const double* var_log_1m_psil,
    const int32_t* var_last_phone, int32_t sil_tpl, int32_t sil_phone,
    double log_p_init, double log_1m_p_init, double sil_corr,
    double nonsil_corr, int32_t num_threads) {
  TemplateTable T{nt, tpl_n_states, tpl_n_inst, tpl_state_off, tpl_pdf,
                  tpl_tstate, tpl_hmm, tpl_phone, tpl_word_rel, tpl_inst_rel,
                  tpl_arc_off, tpl_arc_src, tpl_arc_dst, tpl_arc_w,
                  tpl_arc_tid, tpl_branch_off, br_entry, br_lset_off, br_lset,
                  br_exit_off, br_exit_state, br_exit_w, br_exit_tid};
  Program P{n_utts, utt_word_off, word_var_off, var_tpl, var_cost,
            var_log_psil, var_log_1m_psil, var_last_phone, sil_tpl, sil_phone,
            log_p_init, log_1m_p_init, sil_corr, nonsil_corr};
  auto* h = new BatchHandle();
  h->graphs.resize(n_utts);
  int32_t nthr = num_threads < 1 ? 1 : num_threads;
  if (nthr > n_utts) nthr = n_utts > 0 ? n_utts : 1;
  if (nthr <= 1) {
    for (int32_t u = 0; u < n_utts; ++u) compile_one(T, P, u, &h->graphs[u]);
  } else {
    std::vector<std::thread> threads;
    for (int32_t t = 0; t < nthr; ++t)
      threads.emplace_back([&, t]() {
        for (int32_t u = t; u < n_utts; u += nthr)
          compile_one(T, P, u, &h->graphs[u]);
      });
    for (auto& th : threads) th.join();
  }
  return h;
}

void gac_get_dims(void* handle, int32_t i, int32_t* S, int32_t* K) {
  auto* h = static_cast<BatchHandle*>(handle);
  *S = h->graphs[i].S;
  *K = h->graphs[i].K;
}

void gac_copy_graph(void* handle, int32_t i, int32_t* in_src, float* in_weight,
                    int32_t* in_tid, float* start, float* final_w,
                    int32_t* final_tid, int32_t* pdf, int32_t* phone,
                    int32_t* word, int32_t* hmm, int32_t* tstate,
                    int32_t* instance) {
  auto* h = static_cast<BatchHandle*>(handle);
  const Graph& g = h->graphs[i];
  const size_t sk = (size_t)g.S * g.K;
  std::memcpy(in_src, g.in_src.data(), sk * sizeof(int32_t));
  std::memcpy(in_weight, g.in_weight.data(), sk * sizeof(float));
  std::memcpy(in_tid, g.in_tid.data(), sk * sizeof(int32_t));
  std::memcpy(start, g.start.data(), g.S * sizeof(float));
  std::memcpy(final_w, g.final_w.data(), g.S * sizeof(float));
  std::memcpy(final_tid, g.final_tid.data(), g.S * sizeof(int32_t));
  std::memcpy(pdf, g.pdf.data(), g.S * sizeof(int32_t));
  std::memcpy(phone, g.phone.data(), g.S * sizeof(int32_t));
  std::memcpy(word, g.word.data(), g.S * sizeof(int32_t));
  std::memcpy(hmm, g.hmm.data(), g.S * sizeof(int32_t));
  std::memcpy(tstate, g.tstate.data(), g.S * sizeof(int32_t));
  std::memcpy(instance, g.instance.data(), g.S * sizeof(int32_t));
}

void gac_free(void* handle) { delete static_cast<BatchHandle*>(handle); }

}  // extern "C"
