"""Condensed-formula parsing: "CO2Et"/"CH2N(CH3)2" -> SMILES.

Behavioral re-implementation of the reference's condensed-formula machinery
(`MolNexTR/chemical.py:290-487`): tokenize with the
abbreviation-aware regex, expand CaXb carbon runs, then depth-first search
over per-atom valence choices to find a chain that satisfies the number of
bonds entering the group, trying left-to-right then right-to-left.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

from molnextr_tpu_torch.chem.abbreviations import (
    ABBREVIATIONS,
    FORMULA_REGEX,
    RGROUP_SYMBOLS,
    VALENCES,
)

FormulaList = List[Union[str, list]]

MAX_TRIALS = 10000


def _parse_tokens(tokens: List[str]) -> list:
    """Tokens -> list of (element-or-sublist, count) pairs."""
    elements = []
    i = 0
    j = 0
    while i < len(tokens):
        if tokens[i] == "(":
            while j < len(tokens) and tokens[j] != ")":
                j += 1
            elt: Union[str, list] = _parse_tokens(tokens[i + 1 : j])
        else:
            elt = tokens[i]
        j += 1
        if j < len(tokens) and tokens[j].isnumeric():
            num = int(tokens[j])
            j += 1
        else:
            num = 1
        elements.append((elt, num))
        i = j
    return elements


def parse_formula(formula: str) -> list:
    """"C2H4O" -> [('C', 2), ('H', 4), ('O', 1)]."""
    return _parse_tokens(FORMULA_REGEX.findall(formula))


def expand_carbon(elements: list) -> FormulaList:
    """Flatten (elt, num) pairs, interleaving CaXb runs: C2H4O ->
    ['C','H','H','C','H','H','O'] (`chemical.py:329-361`)."""
    expanded: FormulaList = []
    i = 0
    while i < len(elements):
        elt, num = elements[i]
        if elt == "C" and num > 1 and i + 1 < len(elements):
            next_elt, next_num = elements[i + 1]
            quotient, remainder = next_num // num, next_num % num
            for _ in range(num):
                expanded.append("C")
                for _ in range(quotient):
                    expanded.append(next_elt)
            for _ in range(remainder):
                expanded.append(next_elt)
            i += 2
        elif isinstance(elt, list):
            new_elt = expand_carbon(elt)
            for _ in range(num):
                expanded.append(new_elt)
            i += 1
        else:
            for _ in range(num):
                expanded.append(elt)
            i += 1
    return expanded


def _expand_abbreviation(abbrev: str) -> str:
    """Symbol -> SMILES fragment; R-groups become `*` placeholders."""
    if abbrev in ABBREVIATIONS:
        return ABBREVIATIONS[abbrev].smiles
    if abbrev in RGROUP_SYMBOLS or (abbrev[:1] == "R" and abbrev[1:].isdigit()):
        if abbrev[1:].isdigit():
            return f"[{abbrev[1:]}*]"
        return "*"
    return f"[{abbrev}]"


def _bond_symbol(order: int) -> str:
    return {0: ".", 1: "", 2: "=", 3: "#"}.get(order, "")


def formula_list_to_smiles(
    formula_list: FormulaList,
    start_bond: int,
    end_bond: Optional[int] = None,
    direction: Optional[int] = None,
) -> Tuple[Optional[str], Optional[int], int, bool]:
    """DFS over valence choices (`chemical.py:394-487`).

    Returns (smiles, bonds_left, num_trials, success).
    """
    if direction is None:
        num_trials = 1
        for dir_choice in (1, -1):
            smiles, bonds_left, trials, success = formula_list_to_smiles(
                formula_list, start_bond, end_bond, dir_choice
            )
            num_trials += trials
            if success:
                return smiles, bonds_left, num_trials, success
        return None, None, num_trials, False

    def dfs(smiles: str, bonds_left: int, cur_idx: int, add_idx: int):
        num_trials = 1
        at_end = (direction == 1 and add_idx == len(formula_list)) or (
            direction == -1 and add_idx == -1
        )
        if at_end:
            if end_bond is not None and end_bond != bonds_left:
                return smiles, bonds_left, num_trials, False
            return smiles, bonds_left, num_trials, True
        if bonds_left <= 0:
            return smiles, bonds_left, num_trials, False
        to_add = formula_list[add_idx]

        if isinstance(to_add, list):
            # nested formula attaches with valence 1
            if bonds_left > 1:
                add_str, val, trials, success = formula_list_to_smiles(
                    to_add, 1, None, direction
                )
                num_trials += trials
                if not success:
                    return smiles, bonds_left, num_trials, False
                if val and val > 0:
                    add_str = _bond_symbol(val + 1) + add_str
                result = dfs(
                    smiles + f"({add_str})", bonds_left - 1, cur_idx, add_idx + direction
                )
            else:
                add_str, new_left, trials, success = formula_list_to_smiles(
                    to_add, 1, None, direction
                )
                num_trials += trials
                if not success:
                    return smiles, bonds_left, num_trials, False
                result = dfs(smiles + add_str, new_left, add_idx, add_idx + direction)
            s, bl, trials, success = result
            num_trials += trials
            return s, bl, num_trials, success

        for val in VALENCES.get(to_add, [1]):
            add_str = _expand_abbreviation(to_add)
            if bonds_left > val:
                if cur_idx >= 0:
                    add_str = _bond_symbol(val) + add_str
                result = dfs(
                    smiles + f"({add_str})", bonds_left - val, cur_idx, add_idx + direction
                )
            else:
                if cur_idx >= 0:
                    add_str = _bond_symbol(bonds_left) + add_str
                result = dfs(smiles + add_str, val - bonds_left, add_idx, add_idx + direction)
            trials, success = result[2:]
            num_trials += trials
            if success:
                return result[0], result[1], num_trials, success
            if num_trials > MAX_TRIALS:
                break
        return smiles, bonds_left, num_trials, False

    cur_idx = -1 if direction == 1 else len(formula_list)
    add_idx = 0 if direction == 1 else len(formula_list) - 1
    return dfs("", start_bond, cur_idx, add_idx)


def condensed_formula_to_smiles(symbol: str, total_bonds: int) -> Optional[str]:
    """Full pipeline: symbol string -> substituent SMILES or None."""
    if len(symbol) > 20:
        return None
    try:
        formula_list = expand_carbon(parse_formula(symbol))
        smiles, _bonds_left, _trials, success = formula_list_to_smiles(
            formula_list, total_bonds, None
        )
    except Exception:
        return None
    return smiles if success else None
