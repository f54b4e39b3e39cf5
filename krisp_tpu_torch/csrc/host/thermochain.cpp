// Exact secondary-structure chain DP over maximal complementary runs.
//
// The thermo screens (krisp_tpu/thermo/nn.py) model a secondary structure
// as a chain of perfectly-complementary stacked helices joined by bulges /
// internal loops — the structure grammar of libprimer3's thal, the engine
// the reference calls (reference src/krisp/krisp_fasta/
// Amplicon.py:143-151).  This kernel searches that grammar EXHAUSTIVELY:
// any number of helices per structure, every maximal run eligible, exact
// via a Pareto front of (dH, dS) per run — both ranking objectives
// (bimolecular Tm for duplexes, -dG37 for hairpins) are monotone in
// (-dH, +dS), so the max-rank structure is always on the front.
//
// Per candidate: runs sorted by start; front[r] = Pareto set of structures
// whose innermost/3'-most helix is run r (single helices eligible to stand
// alone only at len >= 3; chain members need len >= 2 — nn.py's classes).
// Joins follow nn.py's geometry: gap1 (outer coordinate) >= 0, gap2 >= 0,
// gap1 + gap2 > 0, bulge when either side is 0, loop size clipped at
// max_loop; non-finite table entries (1-2 nt internal loops) are illegal.
//
// krisp_tpu/thermo/chain.py binds this via ctypes and falls back to the
// pure-Python DP (thermo/oracle.py) when no toolchain is available.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

struct Entry {
  double dh, ds;
  uint8_t elig;  // may stand as a finished structure
};

// dh asc, then ds desc, then eligible first: the sweep below keeps an
// entry only if it strictly improves ds over every kept dominator.
bool entry_lt(const Entry& a, const Entry& b) {
  if (a.dh != b.dh) return a.dh < b.dh;
  if (a.ds != b.ds) return a.ds > b.ds;
  return a.elig > b.elig;
}

}  // namespace

extern "C" int krisp_thermo_chain(
    int64_t n_cand,
    const int64_t* offsets,  // [n_cand+1] into the run arrays
    const int32_t* i0, const int32_t* i1,   // run start/end, first coord
    const int32_t* k0, const int32_t* k1,   // run start/end, second coord
    const int32_t* rlen,                    // run length (matched cells)
    const double* rdh, const double* rds,   // run stack energies
    int32_t inner_desc,   // 1: hairpin geometry (k decreases inward)
    int32_t hairpin,      // 1: rank by -dG37 + terminal loop; 0: duplex Tm
    const int32_t* end_i,  // [n_cand] 3'-anchor for the END screen, or NULL
    const double* bulge_ds, const double* internal_ds,
    const double* hairpin_ds,  // [max_loop+1] entropic loop tables
    int32_t max_loop,
    double tmm_ds,    // loop-closure terminal-mismatch dS (loops > 3 nt)
    double dangle5_ds,  // 5'-dangle dS at the open stem end (hairpins,
                        // outermost helix with i0 > 0; nn.DANGLE5_DS)
    double t37,       // 310.15 K
    double salt_ds,   // 0.368 * ln(salt): dS salt correction
    double rlogc,     // R * ln(c/4): duplex Tm concentration term
    int32_t threads,  // worker team size (candidates are independent)
    double* out       // [n_cand*4]: any_dh, any_ds, end_dh, end_ds
) {
  const int T = threads > 0
      ? static_cast<int>(std::min<int64_t>(threads, n_cand ? n_cand : 1))
      : 1;
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
  std::vector<int> order;
  std::vector<std::vector<Entry>> fronts;
  std::vector<Entry> buf;
  for (int64_t c = next.fetch_add(1); c < n_cand;
       c = next.fetch_add(1)) {
    const int64_t lo = offsets[c];
    const int R = static_cast<int>(offsets[c + 1] - lo);
    double best_any = -INFINITY, best_end = -INFINITY;
    double any_dh = 0, any_ds = 0, end_dh = 0, end_ds = 0;
    order.resize(R);
    for (int r = 0; r < R; ++r) order[r] = r;
    // joins need outer.i1 < inner.i0, so i0 order is topological
    std::sort(order.begin(), order.end(), [&](int a, int b) {
      if (i0[lo + a] != i0[lo + b]) return i0[lo + a] < i0[lo + b];
      return a < b;
    });
    fronts.assign(R, {});
    for (int rr = 0; rr < R; ++rr) {
      const int64_t r = lo + order[rr];
      buf.clear();
      // base entry = this run as the OUTERMOST helix; hairpin chains
      // whose outer stem carries a 5' flank base earn the dangle term
      const double ds0 =
          rds[r] + ((hairpin && i0[r] > 0) ? dangle5_ds : 0.0);
      buf.push_back({rdh[r], ds0, static_cast<uint8_t>(rlen[r] >= 3)});
      for (int ss = 0; ss < rr; ++ss) {
        const int64_t s = lo + order[ss];
        const int g1 = i0[r] - i1[s] - 1;
        const int g2 = inner_desc ? (k1[s] - k0[r] - 1)
                                  : (k0[r] - k1[s] - 1);
        if (g1 < 0 || g2 < 0 || g1 + g2 == 0) continue;
        const int size = std::min(g1 + g2, static_cast<int>(max_loop));
        const double dsj =
            (g1 == 0 || g2 == 0) ? bulge_ds[size] : internal_ds[size];
        if (!std::isfinite(dsj)) continue;
        for (const Entry& e : fronts[ss])
          buf.push_back({e.dh + rdh[r], e.ds + rds[r] + dsj, 1});
      }
      std::sort(buf.begin(), buf.end(), entry_lt);
      std::vector<Entry>& front = fronts[rr];
      front.clear();
      double ds_any = -INFINITY;   // max ds among kept entries
      double ds_elig = -INFINITY;  // max ds among kept ELIGIBLE entries
      for (const Entry& e : buf) {
        // an eligible entry may only be pruned by an eligible dominator
        if (e.ds <= (e.elig ? ds_elig : ds_any)) continue;
        front.push_back(e);
        if (e.elig && e.ds > ds_elig) ds_elig = e.ds;
        if (e.ds > ds_any) ds_any = e.ds;
      }
      // score finished structures whose final helix is this run
      double ds_term = 0.0;
      if (hairpin) {
        int tl = k1[r] - i1[r] - 1;
        tl = std::min(std::max(tl, 3), static_cast<int>(max_loop));
        ds_term = hairpin_ds[tl] + (tl > 3 ? tmm_ds : 0.0);
      }
      const bool at_end = end_i != nullptr && i1[r] == end_i[c];
      for (const Entry& e : front) {
        if (!e.elig || e.dh >= 0) continue;
        const double ds_tot = e.ds + ds_term;
        double rank;
        if (hairpin) {
          rank = -(e.dh * 1000.0 - t37 * (ds_tot + salt_ds));
        } else {
          if (e.ds >= 0) continue;  // nn._tm_of's guard on the raw dS
          // associate exactly as nn._tm_of: (ds + salt) + R*ln(c/4),
          // minus 273.15, so native and Python rank bit-identically
          rank = e.dh * 1000.0 / ((ds_tot + salt_ds) + rlogc) - 273.15;
        }
        if (rank > best_any) {
          best_any = rank;
          any_dh = e.dh;
          any_ds = ds_tot;
        }
        if (at_end && rank > best_end) {
          best_end = rank;
          end_dh = e.dh;
          end_ds = ds_tot;
        }
      }
    }
    out[c * 4 + 0] = any_dh;
    out[c * 4 + 1] = any_ds;
    out[c * 4 + 2] = end_dh;
    out[c * 4 + 3] = end_ds;
  }
  };
  if (T <= 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    ts.reserve(T - 1);
    for (int t = 1; t < T; ++t) ts.emplace_back(worker);
    worker();
    for (auto& th : ts) th.join();
  }
  return 0;
}
