"""SMILES writer: :class:`Mol` -> canonical (isomeric) SMILES text.

Replaces ``Chem.MolToSmiles(mol, isomericSmiles=True, canonical=True)`` used
throughout the reference chemistry layer (`chemical.py:870-940`).  Traversal
order comes from :func:`molnextr_tpu.chem.canon.canonical_ranks`; tetrahedral
parity and double-bond cis/trans are re-derived for the written neighbor
order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from molnextr_tpu_torch.chem.mol import (
    AROMATIC, CHI_CCW, CHI_CW, CHI_NONE, DOUBLE, ORGANIC_SUBSET, SINGLE,
    TRIPLE, Atom, Bond, Mol,
)
from molnextr_tpu_torch.chem.canon import canonical_ranks

_BOND_CHAR = {SINGLE: "", DOUBLE: "=", TRIPLE: "#", AROMATIC: ""}


def _perm_parity(src: List[int], dst: List[int]) -> Optional[int]:
    """Parity (0 even / 1 odd) of the permutation mapping src order to dst."""
    if sorted(src) != sorted(dst) or len(src) != len(set(src)):
        return None
    perm = [src.index(x) for x in dst]
    parity = 0
    seen = [False] * len(perm)
    for i in range(len(perm)):
        if seen[i]:
            continue
        j, clen = i, 0
        while not seen[j]:
            seen[j] = True
            j = perm[j]
            clen += 1
        parity ^= (clen - 1) & 1
    return parity


class _Writer:
    def __init__(self, mol: Mol, ranks: List[int], isomeric: bool, alias_mode: bool):
        self.mol = mol
        self.ranks = ranks
        self.isomeric = isomeric
        self.alias_mode = alias_mode
        n = mol.num_atoms()
        self.visited = [False] * n
        self.parent: List[Optional[int]] = [None] * n
        self.children: List[List[int]] = [[] for _ in range(n)]
        self.ring_digits: List[List[Tuple[int, int]]] = [[] for _ in range(n)]  # (digit, partner)
        self.ring_bond_symbol: Dict[Tuple[int, int], str] = {}
        self.next_digit = 1
        self.free_digits: List[int] = []
        self.direction: Dict[Tuple[int, int], str] = {}  # (x, y) written x->y

    # -- pass 1: DFS tree + ring bond digit assignment -------------------
    def build_tree(self, root: int) -> None:
        stack = [(root, None)]
        self.visited[root] = True
        order_key = lambda x: self.ranks[x]
        # iterative DFS preserving child order
        def visit(a: int):
            nbs = sorted((n for n in self.mol.neighbors(a)), key=order_key)
            for nb in nbs:
                if nb == self.parent[a]:
                    continue
                bidx = self.mol.bond_between(a, nb)
                if self.visited[nb]:
                    key = (min(a, nb), max(a, nb))
                    if key in self.ring_bond_symbol:
                        continue  # already closed from the other side
                    digit = self.free_digits.pop() if self.free_digits else self.next_digit
                    if digit == self.next_digit:
                        self.next_digit += 1
                    self.ring_digits[nb].append((digit, a))
                    self.ring_digits[a].append((digit, nb))
                    self.ring_bond_symbol[key] = _BOND_CHAR[self.mol.bonds[bidx].order]
                else:
                    self.visited[nb] = True
                    self.parent[nb] = a
                    self.children[a].append(nb)
                    visit(nb)

        visit(root)

    # -- stereo ----------------------------------------------------------
    def assign_directions(self) -> None:
        """Choose /-\\ markers satisfying the molecule's db_stereo specs.

        Solved as parity constraints over variables ``u[(n, c)]`` (= +1 when
        neighbor n is drawn above stereo center c):

        * ``u[(n, c)] = -u[(c, n)]``            (a bond's slope, seen from
          either end — this ties conjugated systems together);
        * neighbors on the same center sit on opposite sides;
        * a cis spec equates the two ends, trans negates.

        BFS 2-coloring over the constraint graph makes the assignment
        deterministic for any atom numbering (an earlier greedy version gave
        conjugated dienes different — and sometimes wrong — markers
        depending on traversal order).
        """
        specs = getattr(self.mol, "db_stereo", None)
        if not self.isomeric or not specs:
            return
        from collections import defaultdict

        adj: Dict[Tuple[int, int], List[Tuple[Tuple[int, int], int]]] = defaultdict(list)

        def relate(a: Tuple[int, int], b: Tuple[int, int], rel: int) -> None:
            adj[a].append((b, rel))
            adj[b].append((a, rel))

        centers = set()
        for (c1, n1, c2, n2, cis) in specs:
            centers.add(c1)
            centers.add(c2)
            relate((n1, c1), (n2, c2), 1 if cis else -1)
        for c in centers:
            nbrs = [
                b.other(c) for b in self.mol.bonds_of(c) if b.order == SINGLE
            ]
            for n in nbrs:
                relate((n, c), (c, n), -1)
            for i in range(len(nbrs)):
                for j in range(i + 1, len(nbrs)):
                    relate((nbrs[i], c), (nbrs[j], c), -1)

        u: Dict[Tuple[int, int], int] = {}
        # canonical seeding: order components by canonical rank so the
        # up/down gauge choice is numbering-invariant
        for start in sorted(adj, key=lambda nc: (self.ranks[nc[0]], self.ranks[nc[1]])):
            if start in u:
                continue
            u[start] = 1
            stack = [start]
            while stack:
                a = stack.pop()
                for b, rel in adj[a]:
                    want = u[a] * rel
                    if b in u:
                        continue  # conflicts only from contradictory specs
                    u[b] = want
                    stack.append(b)

        for (n, c), val in u.items():
            bidx = self.mol.bond_between(n, c)
            if bidx is None or self.mol.bonds[bidx].order != SINGLE:
                continue
            # written orientation x->y: "/" means y above x
            self.direction[(c, n)] = "/" if val > 0 else "\\"
            self.direction[(n, c)] = "/" if val < 0 else "\\"

    def bond_text(self, x: int, y: int) -> str:
        bidx = self.mol.bond_between(x, y)
        bond = self.mol.bonds[bidx]
        if bond.order == SINGLE and (x, y) in self.direction:
            return self.direction[(x, y)]
        a, b = self.mol.atoms[x], self.mol.atoms[y]
        if bond.order == SINGLE and a.aromatic and b.aromatic:
            return "-"  # single bond between two aromatic atoms (biphenyl)
        if bond.order == AROMATIC and not (a.aromatic and b.aromatic):
            return ":"
        return _BOND_CHAR[bond.order]

    # -- atom tokens ------------------------------------------------------
    def atom_token(self, idx: int) -> str:
        atom = self.mol.atoms[idx]
        if atom.alias and self.alias_mode:
            return f"[{atom.alias}]"
        sym = atom.symbol
        chiral = atom.chiral if self.isomeric else CHI_NONE
        written_order = self.written_neighbor_order(idx)
        tag = ""
        if chiral != CHI_NONE and written_order is not None:
            stored = self.mol.atoms[idx].chiral_order
            parity = _perm_parity(stored, written_order)
            if parity is not None:
                eff = chiral if parity == 0 else (CHI_CW if chiral == CHI_CCW else CHI_CCW)
                tag = "@" if eff == CHI_CCW else "@@"
        h = self.mol.total_h(idx) - sum(
            1 for n in self.mol.neighbors(idx) if self.mol.atoms[n].symbol == "H"
        )
        needs_bracket = (
            sym not in ORGANIC_SUBSET
            or atom.charge != 0
            or atom.isotope != 0
            or atom.map_num != 0
            or tag != ""
            or atom.radical > 0
            or (sym == "*" and atom.isotope != 0)
        )
        body = sym.lower() if atom.aromatic else sym
        if not needs_bracket and self._default_h(idx) == h:
            # organic-subset atom whose H count equals the default implicit
            return body
        out = "["
        if atom.isotope:
            out += str(atom.isotope)
        out += body
        out += tag
        if h == 1:
            out += "H"
        elif h > 1:
            out += f"H{h}"
        if atom.charge == 1:
            out += "+"
        elif atom.charge == -1:
            out += "-"
        elif atom.charge > 1:
            out += f"+{atom.charge}"
        elif atom.charge < -1:
            out += f"-{-atom.charge}"
        if atom.map_num:
            out += f":{atom.map_num}"
        out += "]"
        return out

    def _default_h(self, idx: int) -> int:
        saved = self.mol.atoms[idx].explicit_h
        self.mol.atoms[idx].explicit_h = -1
        h = self.mol.implicit_h(idx)
        self.mol.atoms[idx].explicit_h = saved
        return h

    def written_neighbor_order(self, idx: int) -> Optional[List[int]]:
        """Neighbor order as it appears in the output (for parity).

        -1 denotes the in-bracket implicit hydrogen slot.
        """
        atom = self.mol.atoms[idx]
        order: List[int] = []
        if self.parent[idx] is not None:
            order.append(self.parent[idx])
        h = self.mol.total_h(idx) - sum(
            1 for n in self.mol.neighbors(idx) if self.mol.atoms[n].symbol == "H"
        )
        if h == 1:
            order.append(-1)
        order.extend(partner for _, partner in self.ring_digits[idx])
        order.extend(self.children[idx])
        if len(order) not in (3, 4):
            return None
        return order

    # -- pass 2: emit -----------------------------------------------------
    def emit(self, idx: int) -> str:
        self.emit_order.append(idx)
        parts = [self.atom_token(idx)]
        for digit, partner in self.ring_digits[idx]:
            sym = ""
            key = (min(idx, partner), max(idx, partner))
            bidx = self.mol.bond_between(idx, partner)
            bond = self.mol.bonds[bidx]
            if bond.order == DOUBLE or bond.order == TRIPLE:
                # emit the order marker only at the first (opening) site
                if not self.visited_for_emit[partner]:
                    sym = _BOND_CHAR[bond.order]
            elif bond.order == SINGLE and (idx, partner) in self.direction:
                sym = self.direction[(idx, partner)]
            parts.append(sym + (str(digit) if digit < 10 else f"%{digit}"))
        self.visited_for_emit[idx] = True
        kids = self.children[idx]
        for j, child in enumerate(kids):
            seg = self.bond_text(idx, child) + self.emit(child)
            if j < len(kids) - 1:
                parts.append(f"({seg})")
            else:
                parts.append(seg)
        return "".join(parts)

    def run(self, root: int) -> str:
        self.build_tree(root)
        self.assign_directions()
        self.visited_for_emit = [False] * self.mol.num_atoms()
        self.emit_order: List[int] = []
        return self.emit(root)


def write_smiles(
    mol: Mol,
    isomeric: bool = True,
    canonical: bool = True,
    alias_mode: bool = False,
    ranks: Optional[List[int]] = None,
    return_order: bool = False,
):
    """Serialize the molecule, one dot-joined fragment per component.

    With ``return_order=True`` also returns the atom emission order — the
    mol atom index of each atom token in output order — which the synthetic
    data generator uses to align graph labels with the SMILES atom counter.
    """
    n = mol.num_atoms()
    if n == 0:
        return ("", []) if return_order else ""
    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 20000))
    try:
        if ranks is None:
            ranks = canonical_ranks(mol) if canonical else list(range(n))
        frags = mol.fragments()
        frags.sort(key=lambda f: min(ranks[a] for a in f))
        out = []
        order: List[int] = []
        for frag in frags:
            root = min(frag, key=lambda a: ranks[a])
            w = _Writer(mol, ranks, isomeric, alias_mode)
            text = w.run(root)
            order.extend(w.emit_order)
            # normalize the up/down gauge freedom: flipping every direction
            # marker in a fragment preserves all cis/trans relations, so fix
            # the first marker to "/" for canonical output
            for ch in text:
                if ch == "/":
                    break
                if ch == "\\":
                    text = text.replace("/", "\x00").replace("\\", "/").replace("\x00", "\\")
                    break
            out.append(text)
        smiles = ".".join(out)
        return (smiles, order) if return_order else smiles
    finally:
        sys.setrecursionlimit(old_limit)
