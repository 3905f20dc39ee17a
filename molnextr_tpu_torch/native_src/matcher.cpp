// Native substructure matcher for the synthetic-data abbreviation collapse.
//
// The host-side hot loop of training-data generation
// (collapse_functional_groups runs ~165 pattern matches per sample).
// VF2-style backtracking subgraph isomorphism with chemistry-aware node
// compatibility (symbol, charge, aromaticity, pinned H counts) and an
// external-bond-valence constraint that makes matched groups contract
// cleanly into superatoms.
//
// It returns the matches of chem/match.py's Python search in the same
// order: the same visit order of pattern atoms, candidates in the Python
// neighbour order (the CSR arrays are built from Mol.neighbors), and a
// match kept when its externals fit and its atom set is new, compared as
// a set (no hash).  Symbols arrive as ids of their strings, so two
// symbols of one atomic number never compare equal.
//
// C ABI only; bound from Python with ctypes (native.py).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct Graph {
  int n;
  const int32_t* sym;        // id of the atom's symbol string
  const int32_t* charge;
  const int32_t* aromatic;   // 0/1
  const int32_t* explicit_h; // -1 = implicit
  const int32_t* total_h;    // resolved H count
  const int32_t* has_alias;  // 0/1 (mol side: existing superatoms never match)
  // CSR adjacency
  const int32_t* adj_off;    // n+1
  const int32_t* adj_nbr;    // neighbor atom index
  const int32_t* adj_ord;    // bond order (1..4)
};

inline int bond_order(const Graph& g, int a, int b) {
  for (int32_t i = g.adj_off[a]; i < g.adj_off[a + 1]; ++i) {
    if (g.adj_nbr[i] == b) return g.adj_ord[i];
  }
  return 0;
}

inline double order_value(int o) { return o == 4 ? 1.5 : double(o); }

struct Matcher {
  const Graph& pat;
  const Graph& mol;
  const int32_t* attach_free;  // per pattern atom: allowed external valence
  int32_t* out;                // [max_matches * pat.n]
  int max_matches;
  int found = 0;

  std::vector<int> order;      // pattern visit order (connected-first)
  std::vector<int> mapping;    // pat idx -> mol idx (-1 unset)
  std::vector<char> used;      // mol atom used
  std::vector<std::vector<int>> seen_sets;  // sorted mol atom sets kept so far

  Matcher(const Graph& p, const Graph& m, const int32_t* af, int32_t* o, int mm)
      : pat(p), mol(m), attach_free(af), out(o), max_matches(mm),
        mapping(p.n, -1), used(m.n, 0) {
    std::vector<char> placed(p.n, 0);
    order.push_back(0);
    placed[0] = 1;
    while ((int)order.size() < p.n) {
      int nxt = -1;
      for (int q : order) {
        for (int32_t i = pat.adj_off[q]; i < pat.adj_off[q + 1]; ++i) {
          int nb = pat.adj_nbr[i];
          if (!placed[nb]) { nxt = nb; break; }
        }
        if (nxt >= 0) break;
      }
      if (nxt < 0) {
        for (int i = 0; i < p.n; ++i) if (!placed[i]) { nxt = i; break; }
      }
      order.push_back(nxt);
      placed[nxt] = 1;
    }
  }

  bool atoms_compatible(int p, int m) const {
    if (pat.sym[p] != mol.sym[m]) return false;
    if (pat.charge[p] != mol.charge[m]) return false;
    if (pat.aromatic[p] != mol.aromatic[m]) return false;
    if (mol.has_alias[m]) return false;
    if (pat.explicit_h[p] >= 0 && mol.total_h[m] != pat.explicit_h[p])
      return false;
    return true;
  }

  bool externals_ok() const {
    for (int p = 0; p < pat.n; ++p) {
      int m = mapping[p];
      double ext = 0.0;
      for (int32_t i = mol.adj_off[m]; i < mol.adj_off[m + 1]; ++i) {
        int nb = mol.adj_nbr[i];
        if (!used[nb]) ext += order_value(mol.adj_ord[i]);
      }
      if (ext > double(attach_free[p]) + 1e-9) return false;
    }
    return true;
  }


  void backtrack(int k) {
    if (found >= max_matches) return;
    if (k == pat.n) {
      std::vector<int> atoms(mapping.begin(), mapping.end());
      std::sort(atoms.begin(), atoms.end());
      for (const auto& s : seen_sets) if (s == atoms) return;
      if (!externals_ok()) return;
      seen_sets.push_back(atoms);
      for (int p = 0; p < pat.n; ++p) out[found * pat.n + p] = mapping[p];
      ++found;
      return;
    }
    int p = order[k];
    // candidates: neighbors of an already-mapped pattern neighbor, else all
    int anchor_q = -1;
    for (int32_t i = pat.adj_off[p]; i < pat.adj_off[p + 1]; ++i) {
      int q = pat.adj_nbr[i];
      if (mapping[q] >= 0) { anchor_q = q; break; }
    }
    const int32_t* cand;
    int n_cand;
    std::vector<int32_t> all;
    if (anchor_q >= 0) {
      int ma = mapping[anchor_q];
      cand = mol.adj_nbr + mol.adj_off[ma];
      n_cand = mol.adj_off[ma + 1] - mol.adj_off[ma];
    } else {
      all.resize(mol.n);
      for (int i = 0; i < mol.n; ++i) all[i] = i;
      cand = all.data();
      n_cand = mol.n;
    }
    for (int ci = 0; ci < n_cand; ++ci) {
      int m = cand[ci];
      if (used[m] || !atoms_compatible(p, m)) continue;
      bool ok = true;
      for (int32_t i = pat.adj_off[p]; i < pat.adj_off[p + 1] && ok; ++i) {
        int q = pat.adj_nbr[i];
        if (mapping[q] < 0) continue;
        if (bond_order(mol, m, mapping[q]) != pat.adj_ord[i]) ok = false;
      }
      if (!ok) continue;
      mapping[p] = m;
      used[m] = 1;
      backtrack(k + 1);
      mapping[p] = -1;
      used[m] = 0;
      if (found >= max_matches) return;
    }
  }
};

}  // namespace

extern "C" {

// Returns the number of matches written to `out` (each match = pat_n int32s
// mapping pattern atom -> mol atom).
int mnx_find_substructures(
    // molecule
    int mol_n, const int32_t* mol_sym, const int32_t* mol_charge,
    const int32_t* mol_aromatic, const int32_t* mol_explicit_h,
    const int32_t* mol_total_h, const int32_t* mol_has_alias,
    const int32_t* mol_adj_off, const int32_t* mol_adj_nbr,
    const int32_t* mol_adj_ord,
    // pattern
    int pat_n, const int32_t* pat_sym, const int32_t* pat_charge,
    const int32_t* pat_aromatic, const int32_t* pat_explicit_h,
    const int32_t* pat_total_h, const int32_t* pat_has_alias,
    const int32_t* pat_adj_off, const int32_t* pat_adj_nbr,
    const int32_t* pat_adj_ord,
    // constraints and output
    const int32_t* attach_free, int32_t* out, int max_matches) {
  if (pat_n == 0 || pat_n > mol_n) return 0;
  Graph mol{mol_n, mol_sym, mol_charge, mol_aromatic, mol_explicit_h,
            mol_total_h, mol_has_alias, mol_adj_off, mol_adj_nbr, mol_adj_ord};
  Graph pat{pat_n, pat_sym, pat_charge, pat_aromatic, pat_explicit_h,
            pat_total_h, pat_has_alias, pat_adj_off, pat_adj_nbr, pat_adj_ord};
  Matcher m(pat, mol, attach_free, out, max_matches);
  m.backtrack(0);
  return m.found;
}

}  // extern "C"
