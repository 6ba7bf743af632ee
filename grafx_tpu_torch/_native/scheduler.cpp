// Native type-scheduling beam search for large audio-processing graphs.
//
// C++ implementation of the scheduler in grafx_tpu_torch/render/order/tensor.py
// (behavioral spec: reference src/grafx/render/order/tensor.py:127-230).
// The search is a host-side, compile-time activity; this native version
// keeps scheduling sub-millisecond for graphs with thousands of nodes,
// where the vectorized-numpy version starts to dominate plan-build time.
//
// Exposed via a plain C ABI (loaded with ctypes; no pybind11 dependency).
//
// Built at first use by grafx_tpu_torch/_native/__init__.py:
//   g++ -O3 -shared -fPIC -std=c++17 scheduler.cpp -o libscheduler_<hash>.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_set>
#include <vector>

namespace {

struct Graph {
  int num_nodes;
  std::vector<int> types;                 // type id per node
  std::vector<std::vector<int>> in_adj;   // predecessors per node
  std::vector<int> sched_types;           // unique non-utility types
};

using Bits = std::vector<uint64_t>;

inline bool get_bit(const Bits& b, int i) {
  return (b[i >> 6] >> (i & 63)) & 1ull;
}
inline void set_bit(Bits& b, int i) { b[i >> 6] |= (1ull << (i & 63)); }

inline int popcount(const Bits& b) {
  int c = 0;
  for (uint64_t w : b) c += __builtin_popcountll(w);
  return c;
}

struct BitsHash {
  size_t operator()(const Bits& b) const {
    size_t h = 1469598103934665603ull;
    for (uint64_t w : b) {
      h ^= w;
      h *= 1099511628211ull;
    }
    return h;
  }
};

// newly-computable nodes of `type` given `visited`
void frontier_of_type(const Graph& g, const Bits& visited, int type,
                      std::vector<int>* out) {
  out->clear();
  for (int n = 0; n < g.num_nodes; ++n) {
    if (g.types[n] != type || get_bit(visited, n)) continue;
    bool ready = true;
    for (int p : g.in_adj[n]) {
      if (!get_bit(visited, p)) {
        ready = false;
        break;
      }
    }
    if (ready) out->push_back(n);
  }
}

// max visited count reachable with `d` more type expansions
int lookahead_score(const Graph& g, const Bits& visited, int d) {
  int best = popcount(visited);
  if (d == 0) return best;
  std::vector<int> nodes;
  for (int t : g.sched_types) {
    frontier_of_type(g, visited, t, &nodes);
    if (nodes.empty()) continue;
    Bits v2 = visited;
    for (int n : nodes) set_bit(v2, n);
    best = std::max(best, lookahead_score(g, v2, d - 1));
  }
  return best;
}

struct State {
  Bits visited;
  std::vector<int32_t> order;  // render order per node (-1 = unassigned)
  std::vector<int32_t> seq;    // type sequence so far
};

}  // namespace

extern "C" {

// Returns the type-sequence length (including leading in=0 and trailing
// out=1), or -1 on failure (cycle / disconnected never-ready nodes).
// out_order: int32[num_nodes]; out_seq: int32[max_seq].
int grafx_beam_search(int num_nodes, int num_edges, const int32_t* src,
                      const int32_t* dst, const int32_t* types, int width,
                      int depth, int32_t* out_order, int32_t* out_seq,
                      int max_seq) {
  const int MAX_ITER = 10000;
  Graph g;
  g.num_nodes = num_nodes;
  g.types.assign(types, types + num_nodes);
  g.in_adj.resize(num_nodes);
  for (int e = 0; e < num_edges; ++e) g.in_adj[dst[e]].push_back(src[e]);

  std::vector<int> uniq(g.types.begin(), g.types.end());
  std::sort(uniq.begin(), uniq.end());
  uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
  for (int t : uniq)
    if (t != 0 && t != 1) g.sched_types.push_back(t);

  const int words = (num_nodes + 63) / 64;
  State init;
  init.visited.assign(words, 0);
  init.order.assign(num_nodes, -1);
  init.seq = {0};
  for (int n = 0; n < num_nodes; ++n) {
    if (g.types[n] == 0) {
      set_bit(init.visited, n);
      init.order[n] = 0;
    } else if (g.types[n] == 1) {
      set_bit(init.visited, n);
    }
  }

  std::vector<State> beam = {init};
  std::vector<int> nodes;
  int iter = 0;
  const State* done = nullptr;

  for (iter = 1; iter <= MAX_ITER; ++iter) {
    // expand: (score, parent, type, frontier nodes)
    struct Cand {
      int score;
      int parent;
      int type;
      std::vector<int> nodes;
      Bits visited;
    };
    std::vector<Cand> cands;
    for (int p = 0; p < (int)beam.size(); ++p) {
      for (int t : g.sched_types) {
        frontier_of_type(g, beam[p].visited, t, &nodes);
        Cand c;
        c.parent = p;
        c.type = t;
        c.nodes = nodes;
        c.visited = beam[p].visited;
        for (int n : nodes) set_bit(c.visited, n);
        c.score = (depth <= 1) ? popcount(c.visited)
                               : lookahead_score(g, c.visited, depth - 1);
        cands.push_back(std::move(c));
      }
    }
    if (cands.empty()) return -1;
    // fail fast on cycles: no candidate makes progress
    bool any_progress = false;
    for (const Cand& c : cands)
      if (!c.nodes.empty()) {
        any_progress = true;
        break;
      }
    if (!any_progress) return -1;
    std::stable_sort(cands.begin(), cands.end(),
                     [](const Cand& a, const Cand& b) {
                       return a.score > b.score;
                     });

    std::vector<State> next;
    std::unordered_set<Bits, BitsHash> seen;
    for (const Cand& c : cands) {
      if ((int)next.size() >= width) break;
      if (!seen.insert(c.visited).second) continue;
      State s;
      s.visited = c.visited;
      s.order = beam[c.parent].order;
      for (int n : c.nodes) s.order[n] = iter;
      s.seq = beam[c.parent].seq;
      s.seq.push_back(c.type);
      next.push_back(std::move(s));
    }
    if (next.empty()) return -1;
    beam = std::move(next);

    for (const State& s : beam) {
      if (popcount(s.visited) == num_nodes) {
        done = &s;
        break;
      }
    }
    if (done) break;
  }
  if (!done) return -1;

  for (int n = 0; n < num_nodes; ++n) {
    out_order[n] = (g.types[n] == 1) ? iter + 1 : done->order[n];
  }
  int seq_len = (int)done->seq.size() + 1;
  if (seq_len > max_seq) return -1;
  for (int i = 0; i < (int)done->seq.size(); ++i) out_seq[i] = done->seq[i];
  out_seq[seq_len - 1] = 1;
  return seq_len;
}
}
