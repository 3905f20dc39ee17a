"""2D coordinate generation for molecular graphs.

The ``mol.layout()`` analogue (reference: Indigo's native layout, called at
`MolNexTR/dataset.py:245`) used by the synthetic training
renderer.  Algorithm:

1. ring perception -> fused ring systems; each system is laid out as regular
   polygons sharing edges (BFS over rings);
2. acyclic atoms placed by BFS with alternating ±30° zig-zag angles off the
   parent direction (standard chemical sketch convention);
3. a light repulsion pass separates colliding atoms.

Bond length is normalized to 1.0.  Output goes to ``mol.coords``.
"""

from __future__ import annotations

import math
import random
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from molnextr_tpu_torch.chem.mol import Mol


def _ring_systems(mol: Mol) -> List[List[List[int]]]:
    """Group SSSR rings into fused systems (sharing >= 1 atom)."""
    rings = mol.ring_info()
    systems: List[List[List[int]]] = []
    assigned = [False] * len(rings)
    for i in range(len(rings)):
        if assigned[i]:
            continue
        group = [rings[i]]
        assigned[i] = True
        atoms = set(rings[i])
        changed = True
        while changed:
            changed = False
            for j in range(len(rings)):
                if not assigned[j] and atoms & set(rings[j]):
                    group.append(rings[j])
                    atoms |= set(rings[j])
                    assigned[j] = True
                    changed = True
        systems.append(group)
    return systems


def _away_direction(mol: Mol, pos: Dict[int, np.ndarray], a: int) -> np.ndarray:
    """Unit vector pointing away from atom a's placed neighbors."""
    away = np.zeros(2)
    for x in mol.neighbors(a):
        if x in pos:
            v = pos[x] - pos[a]
            ln = np.linalg.norm(v)
            if ln > 1e-9:
                away -= v / ln
    ln = np.linalg.norm(away)
    if ln < 1e-6:
        ang = random.uniform(0, 2 * math.pi)
        return np.array([math.cos(ang), math.sin(ang)])
    return away / ln


def _place_ring(
    mol: Mol,
    ring: List[int],
    pos: Dict[int, np.ndarray],
    system_atoms: Set[int],
) -> Dict[int, np.ndarray]:
    """Place one ring as a regular polygon, anchored on already-placed atoms.

    Anchoring cases: shared edge (fused ring) -> polygon on the side away
    from the system's placed centroid; one placed atom (spiro or
    chain-attached ring) -> center along the atom's free direction; nothing
    placed -> polygon at the origin.
    """
    n = len(ring)
    r = 0.5 / math.sin(math.pi / n)
    step = 2 * math.pi / n
    out: Dict[int, np.ndarray] = {}

    # shared-edge anchor: adjacent placed pair in ring order
    k = None
    for i in range(n):
        if ring[i] in pos and ring[(i + 1) % n] in pos:
            k = i
            break
    if k is not None:
        a, b = ring[k], ring[(k + 1) % n]
        pa, pb = pos[a], pos[b]
        mid = (pa + pb) / 2
        edge = pb - pa
        eln = np.linalg.norm(edge)
        norm = (
            np.array([-edge[1], edge[0]]) / eln if eln > 1e-9 else np.array([0.0, 1.0])
        )
        apothem = r * math.cos(math.pi / n)
        # the new ring goes on the side away from the placed part of the
        # same ring system
        others = [pos[x] for x in system_atoms if x in pos and x not in (a, b)]
        if others and np.dot(norm, mid - np.mean(others, axis=0)) < 0:
            norm = -norm
        center = mid + apothem * norm
        ang_a = math.atan2(*(pa - center)[::-1])
        ang_b = math.atan2(*(pb - center)[::-1])
        diff = (ang_b - ang_a) % (2 * math.pi)
        direction = 1 if abs(diff - step) < abs(diff - (2 * math.pi - step)) else -1
        for i in range(n):
            atom = ring[(k + i) % n]
            ang = ang_a + direction * step * i
            out[atom] = center + r * np.array([math.cos(ang), math.sin(ang)])
        return out

    placed = [a for a in ring if a in pos]
    if placed:
        a = placed[0]
        k = ring.index(a)
        d = _away_direction(mol, pos, a)
        center = pos[a] + r * d
        start_ang = math.atan2(*(pos[a] - center)[::-1])
    else:
        k = 0
        center = np.zeros(2)
        start_ang = math.pi / 2
    for i in range(n):
        atom = ring[(k + i) % n]
        ang = start_ang + step * i
        out[atom] = center + r * np.array([math.cos(ang), math.sin(ang)])
    return out


def _side_sign(axis_a: np.ndarray, axis_b: np.ndarray, p: np.ndarray) -> float:
    ax = axis_b - axis_a
    d = p - axis_a
    return float(ax[0] * d[1] - ax[1] * d[0])


def _enforce_db_stereo(mol: Mol, pos: Dict[int, np.ndarray], in_system: Dict[int, int]) -> None:
    """Reflect branches across double-bond axes so drawn geometry matches
    the parsed cis/trans specs (``mol.db_stereo``)."""
    specs = getattr(mol, "db_stereo", None)
    if not specs:
        return
    for (c1, n1, c2, n2, cis) in specs:
        if c1 in in_system and c2 in in_system:
            continue  # ring double bonds keep polygon geometry
        if any(a not in pos for a in (c1, n1, c2, n2)):
            continue
        s1 = _side_sign(pos[c1], pos[c2], pos[n1])
        s2 = _side_sign(pos[c1], pos[c2], pos[n2])
        if abs(s1) < 1e-9 or abs(s2) < 1e-9:
            continue
        drawn_cis = (s1 > 0) == (s2 > 0)
        if drawn_cis == cis:
            continue
        # collect the branch beyond c2 (not crossing back through c2->c1)
        branch = set()
        stack = [x for x in mol.neighbors(c2) if x != c1]
        while stack:
            a = stack.pop()
            if a in branch or a == c2 or a == c1:
                continue
            branch.add(a)
            stack.extend(x for x in mol.neighbors(a) if x not in branch and x != c2)
        a0, a1v = pos[c1], pos[c2]
        ax = a1v - a0
        ln2 = float(ax @ ax)
        if ln2 < 1e-12:
            continue
        for a in branch:
            d = pos[a] - a0
            # reflect across the c1->c2 line
            proj = (d @ ax) / ln2 * ax
            pos[a] = a0 + 2 * proj - d


def layout(mol: Mol, jitter: float = 0.0, seed: Optional[int] = None) -> Mol:
    """Assign 2D coordinates (in place); bond length ~= 1."""
    if seed is not None:
        random.seed(seed)
    n = mol.num_atoms()
    if n == 0:
        mol.coords = []
        return mol
    pos: Dict[int, np.ndarray] = {}
    in_system: Dict[int, int] = {}
    systems = _ring_systems(mol)
    for si, system in enumerate(systems):
        for ring in system:
            for a in ring:
                in_system[a] = si

    placed_systems: Set[int] = set()

    def place_system(si: int):
        if si in placed_systems:
            return
        placed_systems.add(si)
        system_atoms = {a for ring in systems[si] for a in ring}
        remaining = sorted(systems[si], key=len, reverse=True)
        # place rings one at a time, preferring those sharing placed atoms
        while remaining:
            best = None
            for ring in remaining:
                if any(a in pos for a in ring):
                    best = ring
                    break
            if best is None:
                best = remaining[0]
            remaining.remove(best)
            new = _place_ring(mol, best, pos, system_atoms)
            for a, p in new.items():
                if a not in pos:
                    pos[a] = p

    # BFS over the whole graph, fragment by fragment
    frag_offset = 0.0
    for frag in mol.fragments():
        root = frag[0]
        if root in in_system:
            place_system(in_system[root])
        else:
            pos[root] = np.array([frag_offset, 0.0])
        if root not in pos:
            pos[root] = np.array([frag_offset, 0.0])
        q = deque([root])
        seen = {root}
        flip: Dict[int, int] = {root: 1}
        while q:
            cur = q.popleft()
            new_nbs = [x for x in mol.neighbors(cur) if x not in seen]
            for nb in new_nbs:
                seen.add(nb)
            # direction pointing away from already-placed neighbors: the
            # standard sketch rule for substituent placement
            placed_nbs = [x for x in mol.neighbors(cur) if x in pos and x not in new_nbs]
            if placed_nbs:
                away = np.zeros(2)
                for x in placed_nbs:
                    v = pos[x] - pos[cur]
                    ln = np.linalg.norm(v)
                    if ln > 1e-9:
                        away -= v / ln
                if np.linalg.norm(away) < 1e-6:
                    # placed neighbors cancel out (e.g. linear): go perpendicular
                    v = pos[placed_nbs[0]] - pos[cur]
                    away = np.array([-v[1], v[0]])
                away = away / max(np.linalg.norm(away), 1e-9)
            else:
                away = np.array([1.0, 0.0])
            base_ang = math.atan2(away[1], away[0])
            to_place = [nb for nb in new_nbs if nb not in pos]
            k_total = len(to_place)
            sign = flip.get(cur, 1)
            k = 0
            for nb in new_nbs:
                if nb not in pos:
                    if k_total == 1:
                        # zig-zag: ±30 degrees off the away direction
                        ang = base_ang + sign * math.pi / 6
                    else:
                        spread = math.pi / 1.8
                        ang = base_ang + spread * (k / max(k_total - 1, 1) - 0.5)
                    step_v = np.array([math.cos(ang), math.sin(ang)])
                    pos[nb] = pos[cur] + step_v
                    flip[nb] = -sign
                    k += 1
                else:
                    flip.setdefault(nb, -sign)
                if nb in in_system:
                    # anchor the ring system at the atom just placed
                    place_system(in_system[nb])
                q.append(nb)
        # shift fragment to start right of the previous one
        xs = [pos[a][0] for a in frag]
        if frag_offset and xs:
            shift = frag_offset - min(xs)
            for a in frag:
                pos[a] = pos[a] + np.array([shift, 0.0])
        frag_offset = max(pos[a][0] for a in frag) + 2.0

    # enforce cis/trans geometry: reflect the subtree past a double bond when
    # its drawn side contradicts the molecule's db_stereo spec (the default
    # zig-zag draws everything trans)
    _enforce_db_stereo(mol, pos, in_system)

    # overlap relaxation: push non-bonded close pairs apart, but never move
    # ring atoms (their polygon geometry is authoritative).  Vectorized over
    # all candidate pairs per sweep — the scalar pair loop was the single
    # hottest spot of synthetic data generation (60 * n^2 norms per molecule).
    coords = np.array([pos[i] for i in range(n)])
    ring_atom = np.array([i in in_system for i in range(n)], bool)
    threshold = 0.75
    if n > 1:
        bonded = np.zeros((n, n), bool)
        for b in mol.iter_bonds():
            bonded[b.a1, b.a2] = bonded[b.a2, b.a1] = True
        iu, ju = np.triu_indices(n, 1)
        movable = ~(bonded[iu, ju] | (ring_atom[iu] & ring_atom[ju]))
        iu, ju = iu[movable], ju[movable]
        for _ in range(60):
            d = coords[ju] - coords[iu]
            dist = np.hypot(d[:, 0], d[:, 1])
            close = dist < threshold
            if not close.any():
                break
            ci, cj = iu[close], ju[close]
            cd, cdist = d[close], dist[close]
            degenerate = cdist < 1e-6
            if degenerate.any():
                cd = cd.copy()
                cd[degenerate] = [
                    (random.random() - 0.5, random.random() - 0.5)
                    for _ in range(int(degenerate.sum()))
                ]
                cdist = np.maximum(np.hypot(cd[:, 0], cd[:, 1]), 1e-9)
            push = ((threshold - cdist) / cdist)[:, None] * cd
            # ring atom in the pair -> the free atom absorbs the full push;
            # two free atoms split it
            w_j = np.where(ring_atom[ci], 1.0, np.where(ring_atom[cj], 0.0, 0.5))
            disp = np.zeros_like(coords)
            np.add.at(disp, cj, push * w_j[:, None])
            np.add.at(disp, ci, -push * (1.0 - w_j)[:, None])
            coords += disp

    if jitter > 0:
        coords = coords + np.random.uniform(-jitter, jitter, coords.shape)
    mol.coords = [(float(x), float(y)) for x, y in coords]
    return mol
