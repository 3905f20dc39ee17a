"""Tokenizers for the molecular sequence formats.

Re-implements the behavioral surface of the reference tokenizers
(`MolNexTR/tokenization.py`):

* ``Tokenizer``        -- plain atomwise SMILES vocabulary (format ``atomtok``)
* ``NodeTokenizer``    -- interleaved ``atom, x, y`` streams with discretized
                          coordinates (format ``atomtok_coords``)
* ``CharTokenizer``    -- same, but atom tokens split into characters
                          (format ``chartok_coords`` -- the released model)

plus a TPU-specific addition: :meth:`NodeTokenizer.constraint_tables` bakes the
reference's per-step python grammar mask (`tokenization.py:188-198`,
applied at `components.py:300-303`) into two dense numpy tables so the
constraint becomes a single gather inside ``jit``.

Special token ids follow the reference exactly (`tokenization.py:9-13`).
"""

from __future__ import annotations

import json
import os
import random
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PAD_ID = 0
SOS_ID = 1
EOS_ID = 2
UNK_ID = 3
MASK_ID = 4
PAD = "<pad>"
SOS = "<sos>"
EOS = "<eos>"
UNK = "<unk>"
MASK = "<mask>"

# Atomwise SMILES tokenization (drop-in for SmilesPE's atomwise_tokenizer,
# which is unavailable in this environment).  One token per bracket atom,
# two-letter organic-subset halogen, ring-bond digit/%nn, bond or branch
# punctuation, or single atom character.
_SMI_TOKEN_RE = re.compile(
    r"(\[[^\]]+\]|Br|Cl|N|O|S|P|F|I|B|C|b|c|n|o|s|p"
    r"|\(|\)|\.|=|#|-|\+|\\|/|:|~|@|\?|>|\*|\$|%\d{2}|\d)"
)


def atomwise_tokens(smiles: str) -> List[str]:
    """Split a SMILES string into atom-level tokens."""
    tokens = _SMI_TOKEN_RE.findall(smiles)
    # Keep behavior predictable on malformed input: untokenizable characters
    # are dropped (SmilesPE silently drops them as well).
    return tokens


class Tokenizer:
    """Vocabulary-backed text<->id mapping for atomwise SMILES.

    Mirrors `tokenization.py:20-108`.
    """

    def __init__(self, path: Optional[str] = None):
        self.stoi: Dict[str, int] = {}
        self.itos: Dict[int, str] = {}
        if path:
            self.load(path)

    def __len__(self) -> int:
        return len(self.stoi)

    @property
    def output_constraint(self) -> bool:
        return False

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.stoi, f)

    def load(self, path: str) -> None:
        with open(path) as f:
            self.stoi = json.load(f)
        self.itos = {v: k for k, v in self.stoi.items()}

    def fit_on_texts(self, texts: Sequence[str]) -> None:
        vocab = set()
        for text in texts:
            vocab.update(text.split(" "))
        ordered = [PAD, SOS, EOS, UNK] + sorted(vocab)
        self.stoi = {s: i for i, s in enumerate(ordered)}
        self.itos = {i: s for s, i in self.stoi.items()}

    def text_to_sequence(self, text: str, tokenized: bool = True) -> List[int]:
        tokens = text.split(" ") if tokenized else atomwise_tokens(text)
        seq = [SOS_ID]
        seq.extend(self.stoi.get(t, UNK_ID) for t in tokens)
        seq.append(EOS_ID)
        return seq

    def texts_to_sequences(self, texts: Sequence[str]) -> List[List[int]]:
        return [self.text_to_sequence(t) for t in texts]

    def sequence_to_text(self, sequence: Sequence[int]) -> str:
        return "".join(self.itos[i] for i in sequence)

    def predict_caption(self, sequence: Sequence[int]) -> str:
        out = []
        for i in sequence:
            if i in (EOS_ID, PAD_ID):
                break
            out.append(self.itos.get(int(i), UNK))
        return "".join(out)

    def sequence_to_smiles(self, sequence: Sequence[int]) -> Dict:
        return {"smiles": self.predict_caption(sequence)}

    def smiles_to_sequence(
        self,
        smiles: str,
        coords=None,
        mask_ratio: float = 0.0,
        atom_only: bool = False,
    ) -> Tuple[List[int], List[int]]:
        """Uniform dataset-facing interface: plain-SMILES tokenizers emit no
        coordinate tokens and no atom indices."""
        return self.text_to_sequence(smiles, tokenized=False), []

    def constraint_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """No grammar constraint for plain-SMILES decoding."""
        n = max(len(self.stoi), 1)
        return np.zeros((n,), dtype=np.int32), np.zeros((1, n), dtype=bool)


class NodeTokenizer(Tokenizer):
    """Tokenizer with discretized coordinate tokens after every atom token.

    Vocabulary layout (ids):
      ``[0, offset)``                      symbol tokens (incl. 5 specials)
      ``[offset, offset+maxx)``            x-coordinate bins
      ``[offset+maxx, offset+maxx+maxy)``  y bins (when ``sep_xy``; otherwise
                                           shared with the x range)

    Mirrors `tokenization.py:111-327`.
    """

    def __init__(
        self,
        input_size: int = 100,
        path: Optional[str] = None,
        sep_xy: bool = False,
        continuous_coords: bool = False,
        debug: bool = False,
    ):
        super().__init__(path)
        self.maxx = input_size
        self.maxy = input_size
        self.sep_xy = sep_xy
        self.special_tokens = [PAD, SOS, EOS, UNK, MASK]
        self.continuous_coords = continuous_coords
        self.debug = debug

    def __len__(self) -> int:
        if self.sep_xy:
            return self.offset + self.maxx + self.maxy
        return self.offset + max(self.maxx, self.maxy)

    @property
    def offset(self) -> int:
        return len(self.stoi)

    @property
    def output_constraint(self) -> bool:
        return not self.continuous_coords

    def fit_atom_symbols(self, atoms: Sequence[str]) -> None:
        vocab = self.special_tokens + sorted(set(atoms))
        self.stoi = {s: i for i, s in enumerate(vocab)}
        self.itos = {i: s for s, i in self.stoi.items()}

    # -- token classification --------------------------------------------
    def is_x(self, tid: int) -> bool:
        return self.offset <= tid < self.offset + self.maxx

    def is_y(self, tid: int) -> bool:
        if self.sep_xy:
            return self.offset + self.maxx <= tid
        return self.offset <= tid

    def is_symbol(self, tid: int) -> bool:
        return len(self.special_tokens) <= tid < self.offset or tid == UNK_ID

    def is_atom(self, tid: int) -> bool:
        return self.is_symbol(tid) and self.is_atom_token(self.itos[tid])

    @staticmethod
    def is_atom_token(token: str) -> bool:
        return token.isalpha() or token.startswith("[") or token == "*" or token == UNK

    # -- coordinate quantization (`tokenization.py:172-186`) -------------
    def x_to_id(self, x: float) -> int:
        return self.offset + round(x * (self.maxx - 1))

    def y_to_id(self, y: float) -> int:
        base = self.offset + self.maxx if self.sep_xy else self.offset
        return base + round(y * (self.maxy - 1))

    def id_to_x(self, tid: int) -> float:
        return (tid - self.offset) / (self.maxx - 1)

    def id_to_y(self, tid: int) -> float:
        base = self.offset + self.maxx if self.sep_xy else self.offset
        return (tid - base) / (self.maxy - 1)

    # -- grammar constraint ----------------------------------------------
    def get_output_mask(self, tid: int) -> List[bool]:
        """True entries are *disallowed* next tokens (`tokenization.py:188-198`)."""
        n = len(self)
        if self.continuous_coords:
            return [False] * n
        if self.is_atom(tid):
            return [True] * self.offset + [False] * self.maxx + [True] * self.maxy
        if self.is_x(tid):
            return [True] * (self.offset + self.maxx) + [False] * self.maxy
        if self.is_y(tid):
            return [False] * self.offset + [True] * (self.maxx + self.maxy)
        return [False] * n

    def constraint_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """Bake :meth:`get_output_mask` into jit-friendly dense tables.

        Returns ``(token_class, class_mask)`` where ``token_class[tid]`` maps a
        token id to a small grammar-state id and ``class_mask[state]`` is a
        boolean row of *disallowed* next tokens.  Inside the decode loop the
        reference's per-step python mask construction
        (`components.py:300-303`) becomes ``class_mask[token_class[prev]]``.
        """
        n = len(self)
        token_class = np.zeros((n,), dtype=np.int32)
        for tid in range(n):
            if self.continuous_coords:
                break
            if self._class_of(tid) is not None:
                token_class[tid] = self._class_of(tid)
        classes = int(token_class.max()) + 1 if n else 1
        class_mask = np.zeros((classes, n), dtype=bool)
        for tid in range(n):
            cls = token_class[tid]
            if not class_mask[cls].any():
                class_mask[cls] = np.asarray(self.get_output_mask(tid), dtype=bool)
        return token_class, class_mask

    def _class_of(self, tid: int) -> Optional[int]:
        if self.is_atom(tid):
            return 1
        if self.is_x(tid):
            return 2
        if self.is_y(tid):
            return 3
        return 0

    # -- sequence building (`tokenization.py:267-327`) -------------------
    def smiles_to_sequence(
        self,
        smiles: str,
        coords: Optional[Sequence[Sequence[float]]] = None,
        mask_ratio: float = 0.0,
        atom_only: bool = False,
    ) -> Tuple[List[int], List[int]]:
        tokens = atomwise_tokens(smiles)
        labels = [SOS_ID]
        indices: List[int] = []
        atom_idx = -1
        for token in tokens:
            if atom_only and not self.is_atom_token(token):
                continue
            labels.append(self.stoi.get(token, UNK_ID))
            if self.is_atom_token(token):
                atom_idx += 1
                if not self.continuous_coords:
                    self._append_coord_ids(labels, coords, atom_idx, mask_ratio)
                indices.append(len(labels) - 1)
        labels.append(EOS_ID)
        return labels, indices

    def _append_coord_ids(self, labels, coords, atom_idx, mask_ratio) -> None:
        if mask_ratio > 0 and random.random() < mask_ratio:
            labels.append(MASK_ID)
            labels.append(MASK_ID)
            return
        if coords is None:
            return
        if atom_idx < len(coords):
            x, y = coords[atom_idx]
        else:  # more atoms than coords: random filler (ref behavior)
            x, y = random.random(), random.random()
        x = min(max(float(x), 0.0), 1.0)
        y = min(max(float(y), 0.0), 1.0)
        labels.append(self.x_to_id(x))
        labels.append(self.y_to_id(y))

    def sequence_to_smiles(self, sequence: Sequence[int]) -> Dict:
        has_coords = not self.continuous_coords
        smiles = ""
        coords: List[List[float]] = []
        symbols: List[str] = []
        indices: List[int] = []
        for i, label in enumerate(sequence):
            label = int(label)
            if label in (EOS_ID, PAD_ID):
                break
            if self.is_x(label) or self.is_y(label):
                continue
            token = self.itos.get(label, UNK)
            smiles += token
            if self.is_atom_token(token):
                if has_coords:
                    if (
                        i + 3 < len(sequence)
                        and self.is_x(int(sequence[i + 1]))
                        and self.is_y(int(sequence[i + 2]))
                    ):
                        coords.append(
                            [self.id_to_x(int(sequence[i + 1])), self.id_to_y(int(sequence[i + 2]))]
                        )
                        symbols.append(token)
                        indices.append(i + 3)
                else:
                    if i + 1 < len(sequence):
                        symbols.append(token)
                        indices.append(i + 1)
        results = {"smiles": smiles, "symbols": symbols, "indices": indices}
        if has_coords:
            results["coords"] = coords
        return results


class CharTokenizer(NodeTokenizer):
    """Character-level variant; atoms are emitted one character at a time.

    Mirrors `tokenization.py:330-515`, including the ``[...]`` group and
    Cl/Br digraph reassembly in :meth:`sequence_to_smiles` and the weaker
    grammar mask (only the after-x / after-y states are constrained,
    `tokenization.py:383-392`).
    """

    def fit_on_texts(self, texts: Sequence[str]) -> None:
        vocab = set()
        for text in texts:
            vocab.update(list(text))
        vocab.discard(" ")
        ordered = [PAD, SOS, EOS, UNK] + sorted(vocab)
        self.stoi = {s: i for i, s in enumerate(ordered)}
        self.itos = {i: s for s, i in self.stoi.items()}

    def get_output_mask(self, tid: int) -> List[bool]:
        n = len(self)
        if self.continuous_coords:
            return [False] * n
        if self.is_x(tid):
            return [True] * (self.offset + self.maxx) + [False] * self.maxy
        if self.is_y(tid):
            return [False] * self.offset + [True] * (self.maxx + self.maxy)
        return [False] * n

    def _class_of(self, tid: int) -> Optional[int]:
        if self.is_x(tid):
            return 1
        if self.is_y(tid):
            return 2
        return 0

    def smiles_to_sequence(
        self,
        smiles: str,
        coords: Optional[Sequence[Sequence[float]]] = None,
        mask_ratio: float = 0.0,
        atom_only: bool = False,
    ) -> Tuple[List[int], List[int]]:
        tokens = atomwise_tokens(smiles)
        labels = [SOS_ID]
        indices: List[int] = []
        atom_idx = -1
        for token in tokens:
            if atom_only and not self.is_atom_token(token):
                continue
            for c in token:
                labels.append(self.stoi.get(c, UNK_ID))
            if self.is_atom_token(token):
                atom_idx += 1
                if not self.continuous_coords:
                    self._append_coord_ids(labels, coords, atom_idx, mask_ratio)
                indices.append(len(labels) - 1)
        labels.append(EOS_ID)
        return labels, indices

    def sequence_to_smiles(self, sequence: Sequence[int]) -> Dict:
        has_coords = not self.continuous_coords
        smiles = ""
        coords: List[List[float]] = []
        symbols: List[str] = []
        indices: List[int] = []
        seq = [int(t) for t in sequence]
        i = 0
        while i < len(seq):
            label = seq[i]
            if label in (EOS_ID, PAD_ID):
                break
            if self.is_x(label) or self.is_y(label):
                i += 1
                continue
            if not self.is_atom(label):
                smiles += self.itos.get(label, UNK)
                i += 1
                continue
            # collect the full atom token starting at i
            if self.itos[label] == "[":
                j = i + 1
                while j < len(seq):
                    if not self.is_symbol(seq[j]):
                        break
                    if self.itos[seq[j]] == "]":
                        j += 1
                        break
                    j += 1
            elif (
                i + 1 < len(seq)
                and self.is_symbol(seq[i + 1])
                and (
                    (self.itos[label] == "C" and self.itos[seq[i + 1]] == "l")
                    or (self.itos[label] == "B" and self.itos[seq[i + 1]] == "r")
                )
            ):
                j = i + 2
            else:
                j = i + 1
            token = "".join(self.itos.get(seq[k], UNK) for k in range(i, j))
            smiles += token
            if has_coords:
                if j + 2 < len(seq) and self.is_x(seq[j]) and self.is_y(seq[j + 1]):
                    coords.append([self.id_to_x(seq[j]), self.id_to_y(seq[j + 1])])
                    symbols.append(token)
                    indices.append(j + 2)
                    i = j + 2
                else:
                    i = j
            else:
                if j < len(seq):
                    symbols.append(token)
                    indices.append(j)
                i = j
        results = {"smiles": smiles, "symbols": symbols, "indices": indices}
        if has_coords:
            results["coords"] = coords
        return results


def default_vocab_path(name: str) -> str:
    return os.path.join(os.path.dirname(__file__), "vocab", name)


def get_tokenizer(data_cfg) -> Dict[str, Tokenizer]:
    """Factory keyed by output format (`tokenization.py:518-544`)."""
    tokenizer: Dict[str, Tokenizer] = {}
    for fmt in data_cfg.formats:
        if fmt == "atomtok":
            path = data_cfg.vocab_file or default_vocab_path("vocab_uspto.json")
            tokenizer[fmt] = Tokenizer(path)
        elif fmt == "atomtok_coords":
            path = data_cfg.vocab_file or default_vocab_path("vocab_uspto.json")
            tokenizer[fmt] = NodeTokenizer(
                data_cfg.coord_bins, path, data_cfg.sep_xy,
                continuous_coords=data_cfg.continuous_coords,
            )
        elif fmt == "chartok_coords":
            path = data_cfg.vocab_file or default_vocab_path("vocab_chars.json")
            tokenizer[fmt] = CharTokenizer(
                data_cfg.coord_bins, path, data_cfg.sep_xy,
                continuous_coords=data_cfg.continuous_coords,
            )
    return tokenizer
