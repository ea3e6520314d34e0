// Frame-synchronous Viterbi beam decoder over a compiled (H)LG graph —
// the native hot loop behind decode/latgen.py (StreamingLatgen).  Same
// role Kaldi's C++ decoder binaries play for the reference (SURVEY.md
// §2c); semantics are pinned 1:1 against the pure-Python decoder (it
// remains the oracle/fallback): identical beam + histogram pruning,
// epsilon relaxation, traceback arena with reachability compaction, and
// identical float64 arithmetic so decoded outputs match exactly
// (modulo exact-cost ties, which random-real posteriors never produce).
//
// C API (ctypes, see native/__init__.py):
//   pka_graph_create / pka_graph_destroy        — shared, read-only graph
//   pka_latgen_create / reset / push / partial /
//   finish / dead / frames / destroy            — one handle per stream

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

struct Arc {
  int32_t il, ol, next;
  double w;
};

struct Graph {
  int32_t n_states = 0;
  int32_t start = -1;
  // split by emitting-ness once, so the frame loop never tests ilabel
  std::vector<std::vector<Arc>> eps_arcs, emit_arcs;
  std::vector<double> finals;  // +inf = not final
};

struct TB {
  int64_t prev;
  int32_t ol, il;
};

using Tokens = std::unordered_map<int32_t, std::pair<double, int64_t>>;

struct Decoder {
  const Graph* g;
  double ascale, beam;
  int32_t max_active, sym_offset;
  int64_t compact_threshold;
  std::vector<double> log_priors;  // empty = none

  std::vector<TB> tbs;
  Tokens tokens;
  bool dead = false;
  int64_t frames = 0;

  void reset() {
    tbs.clear();
    tbs.push_back({-1, 0, 0});
    tokens.clear();
    tokens.emplace(g->start, std::make_pair(0.0, int64_t{0}));
    eps_expand(tokens);
    dead = false;
    frames = 0;
  }

  void eps_expand(Tokens& toks) {
    std::vector<int32_t> stack;
    stack.reserve(toks.size());
    for (const auto& kv : toks) stack.push_back(kv.first);
    while (!stack.empty()) {
      int32_t s = stack.back();
      stack.pop_back();
      auto cur = toks[s];  // (cost, tb) — re-read at pop time, like Python
      for (const Arc& a : g->eps_arcs[s]) {
        double nc = cur.first + a.w;
        auto it = toks.find(a.next);
        if (it == toks.end() || nc < it->second.first) {
          tbs.push_back({cur.second, a.ol, 0});
          toks[a.next] = {nc, (int64_t)tbs.size() - 1};
          stack.push_back(a.next);
        }
      }
    }
  }

  // returns 1 while alive, 0 once the beam died
  int push(const double* posts, int64_t T, int32_t n_ph) {
    if (dead) return 0;
    for (int64_t t = 0; t < T; ++t) {
      const double* row = posts + t * n_ph;
      Tokens nxt;
      nxt.reserve(tokens.size() * 2 + 16);
      double best = kInf;
      for (const auto& kv : tokens) {
        double cost = kv.second.first;
        int64_t tb = kv.second.second;
        for (const Arc& a : g->emit_arcs[kv.first]) {
          int32_t col = a.il - sym_offset;
          if (col < 0 || col >= n_ph) continue;
          double lp = row[col];
          if (!log_priors.empty()) lp -= log_priors[col];
          double nc = cost + a.w + (-ascale) * lp;
          if (nc >= best + beam) continue;
          auto it = nxt.find(a.next);
          if (it == nxt.end() || nc < it->second.first) {
            tbs.push_back({tb, a.ol, a.il});
            nxt[a.next] = {nc, (int64_t)tbs.size() - 1};
            if (nc < best) best = nc;
          }
        }
      }
      if (nxt.empty()) {
        dead = true;
        return 0;
      }
      double cut = best + beam;
      if ((int64_t)nxt.size() > max_active) {
        std::vector<double> costs;
        costs.reserve(nxt.size());
        for (const auto& kv : nxt)
          if (kv.second.first <= cut) costs.push_back(kv.second.first);
        if ((int64_t)costs.size() > max_active) {
          std::nth_element(costs.begin(), costs.begin() + (max_active - 1),
                           costs.end());
          cut = costs[max_active - 1];
        }
      }
      for (auto it = nxt.begin(); it != nxt.end();) {
        if (it->second.first > cut)
          it = nxt.erase(it);
        else
          ++it;
      }
      eps_expand(nxt);
      tokens = std::move(nxt);
      ++frames;
      if ((int64_t)tbs.size() > compact_threshold) compact();
    }
    return 1;
  }

  void compact() {
    std::unordered_set<int64_t> reach;
    reach.reserve(tokens.size() * 64);
    for (const auto& kv : tokens) {
      int64_t tb = kv.second.second;
      while (tb >= 0 && !reach.count(tb)) {
        reach.insert(tb);
        tb = tbs[tb].prev;
      }
    }
    std::vector<int64_t> order(reach.begin(), reach.end());
    std::sort(order.begin(), order.end());
    std::unordered_map<int64_t, int64_t> remap;
    remap.reserve(order.size() * 2);
    for (size_t i = 0; i < order.size(); ++i) remap[order[i]] = (int64_t)i;
    std::vector<TB> out;
    out.reserve(order.size());
    for (int64_t old : order) {
      const TB& e = tbs[old];
      auto it = remap.find(e.prev);
      out.push_back({it == remap.end() ? -1 : it->second, e.ol, e.il});
    }
    tbs = std::move(out);
    for (auto& kv : tokens) kv.second.second = remap[kv.second.second];
  }

  // best ALIVE token's olabels; returns count (may exceed cap: caller
  // re-calls with a bigger buffer), or -1 if dead/empty
  int64_t partial(int32_t* words, int64_t cap, double* cost) const {
    if (dead || tokens.empty()) return -1;
    double bc = kInf;
    int64_t btb = -1;
    for (const auto& kv : tokens) {
      if (kv.second.first < bc) {
        bc = kv.second.first;
        btb = kv.second.second;
      }
    }
    *cost = bc;
    std::vector<int32_t> rev;
    for (int64_t tb = btb; tb >= 0; tb = tbs[tb].prev)
      if (tbs[tb].ol != 0) rev.push_back(tbs[tb].ol);
    int64_t n = (int64_t)rev.size();
    for (int64_t i = 0; i < n && i < cap; ++i) words[i] = rev[n - 1 - i];
    return n;
  }

  // best FINAL token's (olabel, ilabel) entries in temporal order,
  // epsilon entries included (decode/align.py recovers frame indices by
  // counting emitting entries).  Returns count (may exceed cap), or -1.
  int64_t finish(int32_t* ols, int32_t* ils, int64_t cap,
                 double* cost) const {
    if (dead) return -1;
    double bc = kInf;
    int64_t btb = -1;
    bool found = false;
    for (const auto& kv : tokens) {
      double fw = g->finals[kv.first];
      if (fw == kInf) continue;
      double total = kv.second.first + fw;
      if (total < bc) {
        bc = total;
        btb = kv.second.second;
        found = true;
      }
    }
    if (!found) return -1;
    *cost = bc;
    std::vector<std::pair<int32_t, int32_t>> rev;
    for (int64_t tb = btb; tb >= 0; tb = tbs[tb].prev)
      rev.push_back({tbs[tb].ol, tbs[tb].il});
    int64_t n = (int64_t)rev.size();
    for (int64_t i = 0; i < n && i < cap; ++i) {
      ols[i] = rev[n - 1 - i].first;
      ils[i] = rev[n - 1 - i].second;
    }
    return n;
  }
};

// ---------------------------------------------------------------------------
// lattice-generating decode (decode/latgen.py latgen_lattice's hot loop):
// records every transition within lattice_beam of a surviving token; the
// Python side assembles the WordLattice from the recorded link array and
// runs the forward/backward lattice pruning.
// ---------------------------------------------------------------------------

struct LatLink {
  int32_t ts, ss, td, sd, ol;
  double ac, gw;
};

struct PrunedLink {
  int32_t from, to, ol;
  double ac, gw;
};

struct LatticeDecoder {
  const Graph* g;
  double ascale, beam, lattice_beam;
  int32_t max_active, sym_offset;
  std::vector<double> log_priors;
  std::vector<LatLink> links;
  std::vector<std::pair<int32_t, double>> finals;
  bool ok = false;

  using Toks = std::unordered_map<int32_t, double>;

  void eps_expand_rec(int32_t t, Toks& toks) {
    std::vector<int32_t> stack;
    stack.reserve(toks.size());
    for (const auto& kv : toks) stack.push_back(kv.first);
    while (!stack.empty()) {
      int32_t s = stack.back();
      stack.pop_back();
      double cost = toks[s];
      for (const Arc& a : g->eps_arcs[s]) {
        double nc = cost + a.w;
        auto it = toks.find(a.next);
        double cur = it == toks.end() ? kInf : it->second;
        if (nc < cur + lattice_beam)
          links.push_back({t, s, t, a.next, a.ol, 0.0, a.w});
        if (nc < cur) {
          toks[a.next] = nc;
          stack.push_back(a.next);
        }
      }
    }
  }

  int run(const double* posts, int64_t T, int32_t n_ph) {
    links.clear();
    finals.clear();
    ok = false;
    Toks tokens;
    tokens.emplace(g->start, 0.0);
    eps_expand_rec(0, tokens);
    struct Cand {
      int32_t s;
      const Arc* a;
      double nc, ac;
    };
    std::vector<Cand> cand;
    for (int64_t t = 0; t < T; ++t) {
      const double* row = posts + t * n_ph;
      Toks nxt;
      nxt.reserve(tokens.size() * 2 + 16);
      cand.clear();
      double best = kInf;
      for (const auto& kv : tokens) {
        for (const Arc& a : g->emit_arcs[kv.first]) {
          int32_t col = a.il - sym_offset;
          if (col < 0 || col >= n_ph) continue;
          double lp = row[col];
          if (!log_priors.empty()) lp -= log_priors[col];
          double ac = (-ascale) * lp;
          double nc = kv.second + a.w + ac;
          if (nc >= best + beam) continue;
          cand.push_back({kv.first, &a, nc, ac});
          auto it = nxt.find(a.next);
          if (it == nxt.end() || nc < it->second) {
            nxt[a.next] = nc;
            if (nc < best) best = nc;
          }
        }
      }
      if (nxt.empty()) return 0;
      double cut = best + beam;
      if ((int64_t)nxt.size() > max_active) {
        std::vector<double> costs;
        costs.reserve(nxt.size());
        for (const auto& kv : nxt)
          if (kv.second <= cut) costs.push_back(kv.second);
        if ((int64_t)costs.size() > max_active) {
          std::nth_element(costs.begin(), costs.begin() + (max_active - 1),
                           costs.end());
          cut = costs[max_active - 1];
        }
      }
      for (auto it = nxt.begin(); it != nxt.end();) {
        if (it->second > cut)
          it = nxt.erase(it);
        else
          ++it;
      }
      for (const Cand& c : cand) {
        auto it = nxt.find(c.a->next);
        if (it != nxt.end() && c.nc <= it->second + lattice_beam)
          links.push_back({(int32_t)t, c.s, (int32_t)(t + 1), c.a->next,
                           c.a->ol, c.ac, c.a->w});
      }
      eps_expand_rec((int32_t)(t + 1), nxt);
      tokens = std::move(nxt);
    }
    for (const auto& kv : tokens) {
      double fw = g->finals[kv.first];
      if (fw != kInf) finals.push_back({kv.first, fw});
    }
    ok = !finals.empty();
    if (!ok) return 0;
    return prune((int32_t)T);
  }

  // pruned outputs (decode/latgen.py _prune_lattice semantics, run here
  // so Python never touches the raw link set)
  std::vector<int32_t> out_times;
  std::vector<PrunedLink> out_links;
  std::vector<std::pair<int32_t, double>> out_finals;

  // forward/backward beam pruning over the recorded links, with the
  // Python decoder's node numbering (first-appearance creation order,
  // then renumbered by (time, creation-id)).  Returns 1 ok, -1 cycle.
  int prune(int32_t T) {
    out_times.clear();
    out_links.clear();
    out_finals.clear();
    // node ids in creation order: (0,start) first, then link endpoints
    std::unordered_map<int64_t, int32_t> ids;
    std::vector<int32_t> times;
    auto node = [&](int32_t t, int32_t s) {
      int64_t key = ((int64_t)t << 32) | (uint32_t)s;
      auto it = ids.find(key);
      if (it != ids.end()) return it->second;
      int32_t id = (int32_t)times.size();
      ids.emplace(key, id);
      times.push_back(t);
      return id;
    };
    node(0, g->start);
    struct L {
      int32_t from, to, ol;
      double ac, gw;
    };
    std::vector<L> ls;
    ls.reserve(links.size());
    for (const LatLink& l : links)
      ls.push_back({node(l.ts, l.ss), node(l.td, l.sd), l.ol, l.ac, l.gw});
    std::vector<std::pair<int32_t, double>> fin;
    fin.reserve(finals.size());
    for (const auto& f : finals) fin.push_back({node(T, f.first), f.second});

    int32_t n = (int32_t)times.size();
    // Kahn topological order
    std::vector<int32_t> indeg(n, 0);
    std::vector<std::vector<int32_t>> out(n);
    for (size_t i = 0; i < ls.size(); ++i) {
      indeg[ls[i].to]++;
      out[ls[i].from].push_back((int32_t)i);
    }
    std::vector<int32_t> order;
    order.reserve(n);
    for (int32_t u = 0; u < n; ++u)
      if (indeg[u] == 0) order.push_back(u);
    for (size_t i = 0; i < order.size(); ++i) {
      for (int32_t li : out[order[i]]) {
        if (--indeg[ls[li].to] == 0) order.push_back(ls[li].to);
      }
    }
    if ((int32_t)order.size() != n) return -1;  // cycle

    std::vector<double> fwd(n, kInf), bwd(n, kInf);
    fwd[0] = 0.0;
    for (int32_t u : order) {
      if (fwd[u] == kInf) continue;
      for (int32_t li : out[u]) {
        double c = fwd[u] + ls[li].ac + ls[li].gw;
        if (c < fwd[ls[li].to]) fwd[ls[li].to] = c;
      }
    }
    for (const auto& f : fin)
      if (f.second < bwd[f.first]) bwd[f.first] = f.second;
    for (auto it = order.rbegin(); it != order.rend(); ++it) {
      for (int32_t li : out[*it]) {
        double c = ls[li].ac + ls[li].gw + bwd[ls[li].to];
        if (c < bwd[*it]) bwd[*it] = c;
      }
    }
    double best = kInf;
    for (const auto& f : fin) {
      double c = fwd[f.first] + f.second;
      if (c < best) best = c;
    }
    if (best == kInf) return 0;

    std::vector<char> used(n, 0);
    used[0] = 1;
    std::vector<int32_t> keep;
    for (size_t i = 0; i < ls.size(); ++i) {
      if (fwd[ls[i].from] + ls[i].ac + ls[i].gw + bwd[ls[i].to] <=
          best + lattice_beam) {
        keep.push_back((int32_t)i);
        used[ls[i].from] = 1;
        used[ls[i].to] = 1;
      }
    }
    // renumber used nodes by (time, creation id)
    std::vector<int32_t> used_ids;
    for (int32_t u = 0; u < n; ++u)
      if (used[u]) used_ids.push_back(u);
    std::sort(used_ids.begin(), used_ids.end(),
              [&](int32_t a, int32_t b) {
                return times[a] != times[b] ? times[a] < times[b] : a < b;
              });
    std::vector<int32_t> remap(n, -1);
    for (size_t i = 0; i < used_ids.size(); ++i) {
      remap[used_ids[i]] = (int32_t)i;
      out_times.push_back(times[used_ids[i]]);
    }
    for (int32_t li : keep)
      out_links.push_back({remap[ls[li].from], remap[ls[li].to], ls[li].ol,
                           ls[li].ac, ls[li].gw});
    for (const auto& f : fin)
      if (used[f.first]) out_finals.push_back({remap[f.first], f.second});
    return 1;
  }
};

}  // namespace

extern "C" {

void* pka_latlat_create(void* graph, double acoustic_scale, double beam,
                        double lattice_beam, int32_t max_active,
                        const double* log_priors, int32_t n_priors,
                        int32_t sym_offset) {
  LatticeDecoder* d = new LatticeDecoder();
  d->g = static_cast<const Graph*>(graph);
  d->ascale = acoustic_scale;
  d->beam = beam;
  d->lattice_beam = lattice_beam;
  d->max_active = max_active;
  d->sym_offset = sym_offset;
  if (log_priors && n_priors > 0)
    d->log_priors.assign(log_priors, log_priors + n_priors);
  return d;
}

void pka_latlat_destroy(void* h) { delete static_cast<LatticeDecoder*>(h); }

int32_t pka_latlat_run(void* h, const double* posts, int64_t T,
                       int32_t n_ph) {
  return static_cast<LatticeDecoder*>(h)->run(posts, T, n_ph);
}

int64_t pka_latlat_n_nodes(void* h) {
  return (int64_t)static_cast<LatticeDecoder*>(h)->out_times.size();
}

void pka_latlat_node_times(void* h, int32_t* times) {
  const auto& ts = static_cast<LatticeDecoder*>(h)->out_times;
  std::memcpy(times, ts.data(), ts.size() * sizeof(int32_t));
}

int64_t pka_latlat_n_links(void* h) {
  return (int64_t)static_cast<LatticeDecoder*>(h)->out_links.size();
}

void pka_latlat_links(void* h, int32_t* from, int32_t* to, int32_t* ol,
                      double* ac, double* gw) {
  const auto& ls = static_cast<LatticeDecoder*>(h)->out_links;
  for (size_t i = 0; i < ls.size(); ++i) {
    from[i] = ls[i].from;
    to[i] = ls[i].to;
    ol[i] = ls[i].ol;
    ac[i] = ls[i].ac;
    gw[i] = ls[i].gw;
  }
}

int64_t pka_latlat_n_finals(void* h) {
  return (int64_t)static_cast<LatticeDecoder*>(h)->out_finals.size();
}

void pka_latlat_finals(void* h, int32_t* nodes, double* weights) {
  const auto& fs = static_cast<LatticeDecoder*>(h)->out_finals;
  for (size_t i = 0; i < fs.size(); ++i) {
    nodes[i] = fs[i].first;
    weights[i] = fs[i].second;
  }
}

void* pka_graph_create(int32_t n_states, int32_t start,
                       const int64_t* row_off, const int32_t* il,
                       const int32_t* ol, const double* w, const int32_t* ns,
                       const double* finals) {
  Graph* g = new Graph();
  g->n_states = n_states;
  g->start = start;
  g->eps_arcs.resize(n_states);
  g->emit_arcs.resize(n_states);
  g->finals.assign(finals, finals + n_states);
  for (int32_t s = 0; s < n_states; ++s) {
    for (int64_t a = row_off[s]; a < row_off[s + 1]; ++a) {
      Arc arc{il[a], ol[a], ns[a], w[a]};
      (arc.il == 0 ? g->eps_arcs : g->emit_arcs)[s].push_back(arc);
    }
  }
  return g;
}

void pka_graph_destroy(void* h) { delete static_cast<Graph*>(h); }

void* pka_latgen_create(void* graph, double acoustic_scale, double beam,
                        int32_t max_active, const double* log_priors,
                        int32_t n_priors, int32_t sym_offset,
                        int64_t compact_threshold) {
  Decoder* d = new Decoder();
  d->g = static_cast<const Graph*>(graph);
  d->ascale = acoustic_scale;
  d->beam = beam;
  d->max_active = max_active;
  d->sym_offset = sym_offset;
  d->compact_threshold = compact_threshold;
  if (log_priors && n_priors > 0)
    d->log_priors.assign(log_priors, log_priors + n_priors);
  d->reset();
  return d;
}

void pka_latgen_destroy(void* h) { delete static_cast<Decoder*>(h); }
void pka_latgen_reset(void* h) { static_cast<Decoder*>(h)->reset(); }

int32_t pka_latgen_push(void* h, const double* posts, int64_t T,
                        int32_t n_ph) {
  return static_cast<Decoder*>(h)->push(posts, T, n_ph);
}

int32_t pka_latgen_dead(void* h) {
  return static_cast<Decoder*>(h)->dead ? 1 : 0;
}

int64_t pka_latgen_frames(void* h) {
  return static_cast<Decoder*>(h)->frames;
}

int64_t pka_latgen_partial(void* h, int32_t* words, int64_t cap,
                           double* cost) {
  return static_cast<Decoder*>(h)->partial(words, cap, cost);
}

int64_t pka_latgen_finish(void* h, int32_t* ols, int32_t* ils, int64_t cap,
                          double* cost) {
  return static_cast<Decoder*>(h)->finish(ols, ils, cap, cost);
}

}  // extern "C"
