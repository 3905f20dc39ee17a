"""Functional-group abbreviation tables.

The behavioral counterpart of `MolNexTR/abbrs.py`: a table of
common structure-drawing shorthand (superatoms) with their expansions, the
R-group symbol list, element valences, and the condensed-formula tokenizer.

Expansion convention (shared with the reference's table): each expansion is a
SMILES whose *bracket atoms with unfilled valence* are the attachment points,
in order; the first atom is always the primary attachment.  E.g. ``Boc`` =
``[C](=O)OC(C)(C)C`` — the bracket carbon has three bonds and an explicit
H-count of 0, leaving one open valence that bonds to the main graph.

The ``probability`` drives training-time abbreviation collapse (how often the
synthetic renderer contracts a matched group into its superatom label,
`MolNexTR/dataset.py:38-71`).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

ORGANIC_SET = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}

# Generic-substituent labels that stay as `*` atoms instead of expanding
# (`abbrs.py:8-10`).
RGROUP_SYMBOLS = [
    "R", "R1", "R2", "R3", "R4", "R5", "R6", "R7", "R8", "R9", "R10",
    "R11", "R12", "Ra", "Rb", "Rc", "Rd", "Rf", "X", "Y", "Z", "Q", "A",
    "E", "Ar", "Ar1", "Ar2", "Ari", "Ar3", "Ar4", "Ar5", "Ar6", "Ar7",
    "R'", "1*", "2*", "3*", "4*", "5*", "6*", "7*", "8*", "9*", "10*",
    "11*", "12*", "[a*]", "[b*]", "[c*]", "[d*]", "EWG", "Nu",
]

# Rare elements the synthetic generator may use as stand-ins for pseudoatoms
# when rendering (`abbrs.py:12`).
PLACEHOLDER_ATOMS = ["Lv", "Lu", "Nd", "Yb", "At", "Fm", "Er"]


@dataclass(frozen=True)
class Substitution:
    """One abbreviation family: labels, expansion, collapse probability."""

    abbrvs: Tuple[str, ...]
    smiles: str  # expansion; bracket atoms with open valence = attachments
    probability: float = 0.5


def _s(abbrvs: List[str], smiles: str, p: float = 0.5) -> Substitution:
    return Substitution(tuple(abbrvs), smiles, p)


# Authored fresh from standard organic-chemistry shorthand; covers the
# reference's abbreviation families (`abbrs.py:23-216`).
SUBSTITUTIONS: List[Substitution] = [
    # nitrogen / nitro / nitrile
    _s(["NO2", "O2N"], "[N+](=O)[O-]", 0.5),
    _s(["NO", "ON"], "[N]=O", 0.3),
    _s(["N3"], "[N]=[N+]=[N-]", 0.3),
    _s(["N2"], "[N+]=[N-]", 0.0),
    _s(["CN", "NC"], "[C]#N", 0.5),
    _s(["SCN"], "[S]C#N", 0.3),
    _s(["NCS", "SNC"], "[N]=C=S", 0.3),
    _s(["NCO", "OCN"], "[N]=C=O", 0.3),
    _s(["NH2", "H2N"], "[NH2]", 0.3),
    _s(["NHMe", "MeHN", "MeNH"], "[NH]C", 0.4),
    _s(["NHEt", "EtHN"], "[NH]CC", 0.4),
    _s(["NMe2", "Me2N"], "[N](C)C", 0.5),
    _s(["NEt2", "Et2N"], "[N](CC)CC", 0.5),
    _s(["NBn2"], "[N](Cc1ccccc1)Cc1ccccc1", 0.2),
    _s(["NHPh", "PhHN", "PhNH"], "[NH]c1ccccc1", 0.3),
    _s(["NHOH", "HOHN"], "[NH]O", 0.2),
    _s(["NHNH2", "H2NHN"], "[NH]N", 0.2),
    _s(["NHCN"], "[NH]C#N", 0.1),
    # carbonyl / acid / ester / amide
    _s(["CHO", "OHC"], "[CH]=O", 0.5),
    _s(["COOH", "CO2H", "HOOC", "HO2C"], "[C](=O)O", 0.5),
    _s(["COO-", "CO2-", "-OOC", "-O2C"], "[C](=O)[O-]", 0.3),
    _s(["COMe", "MeOC", "COCH3"], "[C](C)=O", 0.3),
    _s(["CO2Me", "COOMe", "MeO2C", "MeOOC", "CO2CH3"], "[C](=O)OC", 0.5),
    _s(["CO2Et", "COOEt", "EtO2C", "EtOOC"], "[C](=O)OCC", 0.5),
    _s(["CO2Bn", "BnO2C"], "[C](=O)OCc1ccccc1", 0.3),
    _s(["CO2tBu", "tBuO2C"], "[C](=O)OC(C)(C)C", 0.3),
    _s(["COCl", "ClOC", "ClCO"], "[C](Cl)=O", 0.3),
    _s(["CONH2", "H2NOC", "H2NCO"], "[C](N)=O", 0.4),
    _s(["CONHMe", "MeHNOC"], "[C](=O)NC", 0.3),
    _s(["CONMe2", "Me2NOC"], "[C](=O)N(C)C", 0.3),
    _s(["CONEt2", "Et2NOC"], "[C](=O)N(CC)CC", 0.2),
    _s(["CONHPh"], "[C](=O)Nc1ccccc1", 0.2),
    _s(["Ac"], "[C](C)=O", 0.1),
    _s(["OAc", "AcO"], "[O]C(C)=O", 0.7),
    _s(["NHAc", "AcHN", "AcNH"], "[NH]C(C)=O", 0.7),
    _s(["NAc"], "[N]C(C)=O", 0.2),
    _s(["Bz"], "[C](=O)c1ccccc1", 0.2),
    _s(["OBz", "BzO"], "[O]C(=O)c1ccccc1", 0.7),
    _s(["NHBz", "BzHN"], "[NH]C(=O)c1ccccc1", 0.3),
    _s(["Piv"], "[C](=O)C(C)(C)C", 0.2),
    _s(["OPiv", "PivO"], "[O]C(=O)C(C)(C)C", 0.5),
    _s(["Suc"], "[C](=O)CCC(=O)O", 0.2),
    _s(["Cbm"], "[C](N)=O", 0.2),
    # carbamate protecting groups
    _s(["Boc"], "[C](=O)OC(C)(C)C", 0.2),
    _s(["NHBoc", "BocHN", "BocNH"], "[NH]C(=O)OC(C)(C)C", 0.6),
    _s(["NBoc"], "[N]C(=O)OC(C)(C)C", 0.6),
    _s(["OBoc", "BocO"], "[O]C(=O)OC(C)(C)C", 0.3),
    _s(["Cbz"], "[C](=O)OCc1ccccc1", 0.4),
    _s(["NHCbz", "CbzHN", "CbzNH"], "[NH]C(=O)OCc1ccccc1", 0.4),
    _s(["NCbz"], "[N]C(=O)OCc1ccccc1", 0.2),
    _s(["Fmoc"], "[C](=O)OCC1c2ccccc2-c2ccccc21", 0.6),
    _s(["NHFmoc", "FmocHN", "FmocNH"], "[NH]C(=O)OCC1c2ccccc2-c2ccccc21", 0.4),
    _s(["Alloc"], "[C](=O)OCC=C", 0.2),
    _s(["Troc"], "[C](=O)OCC(Cl)(Cl)Cl", 0.2),
    # alkyl
    _s(["Me", "CH3", "H3C", "MeH2C"], "[CH3]", 0.2),
    _s(["Et", "C2H5"], "[CH2]C", 0.3),
    _s(["Pr", "nPr", "n-Pr"], "[CH2]CC", 0.3),
    _s(["iPr", "i-Pr"], "[CH](C)C", 0.3),
    _s(["Bu", "nBu", "n-Bu"], "[CH2]CCC", 0.3),
    _s(["iBu", "i-Bu"], "[CH2]C(C)C", 0.3),
    _s(["sBu", "s-Bu"], "[CH](C)CC", 0.2),
    _s(["tBu", "t-Bu", "But"], "[C](C)(C)C", 0.3),
    _s(["Np", "Neop"], "[CH2]C(C)(C)C", 0.1),
    _s(["Allyl"], "[CH2]C=C", 0.2),
    _s(["Vinyl"], "[CH]=C", 0.2),
    _s(["Cy", "Cyh"], "[CH]1CCCCC1", 0.3),
    _s(["OCy", "CyO"], "[O]C1CCCCC1", 0.5),
    _s(["Bn"], "[CH2]c1ccccc1", 0.2),
    _s(["OBn", "BnO"], "[O]Cc1ccccc1", 0.7),
    _s(["NHBn", "BnHN", "BnNH"], "[NH]Cc1ccccc1", 0.3),
    # aryl
    _s(["Ph", "C6H5"], "[c]1ccccc1", 0.5),
    _s(["OPh", "PhO"], "[O]c1ccccc1", 0.5),
    _s(["SPh", "PhS"], "[S]c1ccccc1", 0.3),
    _s(["Py"], "[c]1ccccn1", 0.1),
    _s(["Mes"], "[c]1c(C)cc(C)cc1C", 0.5),
    _s(["PMP"], "[c]1ccc(OC)cc1", 0.2),
    _s(["PMB"], "[CH2]c1ccc(OC)cc1", 0.2),
    _s(["OPMB", "PMBO"], "[O]Cc1ccc(OC)cc1", 0.3),
    _s(["Tol", "4-Tol"], "[c]1ccc(C)cc1", 0.3),
    _s(["Xyl"], "[c]1cc(C)cc(C)c1", 0.1),
    _s(["1-Naph", "1-Np"], "[c]1cccc2ccccc12", 0.1),
    _s(["2-Naph", "2-Np"], "[c]1ccc2ccccc2c1", 0.1),
    _s(["Bt"], "[N]1N=Nc2ccccc21", 0.1),
    # alkoxy / thio
    _s(["OH", "HO"], "[OH]", 0.2),
    _s(["SH", "HS"], "[SH]", 0.2),
    _s(["OMe", "MeO", "OCH3", "H3CO"], "[O]C", 0.6),
    _s(["OEt", "EtO"], "[O]CC", 0.5),
    _s(["OPr", "PrO", "OnPr"], "[O]CCC", 0.3),
    _s(["OiPr", "iPrO"], "[O]C(C)C", 0.3),
    _s(["OBu", "BuO", "OnBu"], "[O]CCCC", 0.3),
    _s(["OtBu", "tBuO"], "[O]C(C)(C)C", 0.4),
    _s(["OAllyl", "AllylO"], "[O]CC=C", 0.2),
    _s(["SMe", "MeS", "SCH3", "H3CS"], "[S]C", 0.4),
    _s(["SEt", "EtS"], "[S]CC", 0.3),
    _s(["StBu", "tBuS"], "[S]C(C)(C)C", 0.1),
    _s(["SAc", "AcS"], "[S]C(C)=O", 0.2),
    # fluoroalkyl
    _s(["CF3", "F3C"], "[C](F)(F)F", 0.5),
    _s(["CHF2", "F2HC", "CF2H"], "[CH](F)F", 0.3),
    _s(["CH2F", "FH2C"], "[CH2]F", 0.2),
    _s(["CCl3", "Cl3C"], "[C](Cl)(Cl)Cl", 0.3),
    _s(["CBr3", "Br3C"], "[C](Br)(Br)Br", 0.1),
    _s(["C2F5"], "[C](F)(F)C(F)(F)F", 0.2),
    _s(["OCF3", "F3CO"], "[O]C(F)(F)F", 0.4),
    _s(["OCHF2", "F2HCO"], "[O]C(F)F", 0.2),
    _s(["OCCl3", "Cl3CO"], "[O]C(Cl)(Cl)Cl", 0.1),
    _s(["SCF3", "F3CS"], "[S]C(F)(F)F", 0.2),
    _s(["SF5"], "[S](F)(F)(F)(F)F", 0.1),
    # sulfonyl
    _s(["Ms"], "[S](C)(=O)=O", 0.2),
    _s(["OMs", "MsO"], "[O]S(C)(=O)=O", 0.7),
    _s(["NHMs", "MsHN"], "[NH]S(C)(=O)=O", 0.2),
    _s(["Ts", "Tos"], "[S](=O)(=O)c1ccc(C)cc1", 0.5),
    _s(["OTs", "TsO"], "[O]S(=O)(=O)c1ccc(C)cc1", 0.6),
    _s(["NHTs", "TsHN", "TsNH"], "[NH]S(=O)(=O)c1ccc(C)cc1", 0.3),
    _s(["NTs"], "[N]S(=O)(=O)c1ccc(C)cc1", 0.2),
    _s(["Tf"], "[S](=O)(=O)C(F)(F)F", 0.3),
    _s(["OTf", "TfO"], "[O]S(=O)(=O)C(F)(F)F", 0.6),
    _s(["NHTf", "TfHN"], "[NH]S(=O)(=O)C(F)(F)F", 0.1),
    _s(["Bs"], "[S](=O)(=O)c1ccc(Br)cc1", 0.1),
    _s(["Ns"], "[S](=O)(=O)c1ccc([N+](=O)[O-])cc1", 0.1),
    _s(["SO2Me", "MeO2S", "MeSO2"], "[S](C)(=O)=O", 0.3),
    _s(["SO2Et", "EtO2S"], "[S](CC)(=O)=O", 0.2),
    _s(["SO2Ph", "PhO2S", "PhSO2"], "[S](=O)(=O)c1ccccc1", 0.3),
    _s(["SO2Cl", "ClO2S", "ClSO2"], "[S](Cl)(=O)=O", 0.3),
    _s(["SO2NH2", "H2NO2S", "H2NSO2"], "[S](N)(=O)=O", 0.3),
    _s(["SO2NMe2", "Me2NO2S"], "[S](=O)(=O)N(C)C", 0.2),
    _s(["SO3H", "HO3S"], "[S](=O)(=O)O", 0.4),
    _s(["SO3-", "-O3S"], "[S](=O)(=O)[O-]", 0.2),
    _s(["SO2"], "[S](=O)=O", 0.1),
    # silyl / ether protecting groups
    _s(["TMS"], "[Si](C)(C)C", 0.4),
    _s(["OTMS", "TMSO"], "[O][Si](C)(C)C", 0.4),
    _s(["TES"], "[Si](CC)(CC)CC", 0.2),
    _s(["OTES", "TESO"], "[O][Si](CC)(CC)CC", 0.2),
    _s(["TBS", "TBDMS"], "[Si](C)(C)C(C)(C)C", 0.5),
    _s(["OTBS", "TBSO", "OTBDMS", "TBDMSO"], "[O][Si](C)(C)C(C)(C)C", 0.5),
    _s(["TBDPS"], "[Si](c1ccccc1)(c1ccccc1)C(C)(C)C", 0.2),
    _s(["OTBDPS", "TBDPSO"], "[O][Si](c1ccccc1)(c1ccccc1)C(C)(C)C", 0.2),
    _s(["TIPS"], "[Si](C(C)C)(C(C)C)C(C)C", 0.2),
    _s(["OTIPS", "TIPSO"], "[O][Si](C(C)C)(C(C)C)C(C)C", 0.2),
    _s(["SEM"], "[CH2]OCC[Si](C)(C)C", 0.2),
    _s(["OSEM", "SEMO"], "[O]COCC[Si](C)(C)C", 0.1),
    _s(["MOM"], "[CH2]OC", 0.2),
    _s(["OMOM", "MOMO"], "[O]COC", 0.3),
    _s(["MEM"], "[CH2]OCCOC", 0.1),
    _s(["OMEM", "MEMO"], "[O]COCCOC", 0.1),
    _s(["THP"], "[CH]1CCCCO1", 0.2),
    _s(["OTHP", "THPO"], "[O]C1CCCCO1", 0.3),
    _s(["Tr", "Trt"], "[C](c1ccccc1)(c1ccccc1)c1ccccc1", 0.2),
    _s(["OTr", "TrO"], "[O]C(c1ccccc1)(c1ccccc1)c1ccccc1", 0.1),
    # phosphorus
    _s(["PPh3", "Ph3P"], "[P](c1ccccc1)(c1ccccc1)c1ccccc1", 0.2),
    _s(["PPh2", "Ph2P"], "[P](c1ccccc1)c1ccccc1", 0.2),
    _s(["PMe2", "Me2P"], "[P](C)C", 0.1),
    _s(["PCy3", "Cy3P"], "[P](C1CCCCC1)(C1CCCCC1)C1CCCCC1", 0.1),
    _s(["PO3H2", "H2O3P"], "[P](=O)(O)O", 0.2),
    _s(["OPO3H2"], "[O]P(=O)(O)O", 0.1),
    _s(["P(O)(OEt)2", "PO(OEt)2"], "[P](=O)(OCC)OCC", 0.1),
    # misc
    _s(["D"], "[2H]", 0.1),
    _s(["CD3", "D3C"], "[C]([2H])([2H])[2H]", 0.1),
    _s(["CH2OH", "HOCH2", "HOH2C"], "[CH2]O", 0.3),
    _s(["CH2NH2", "H2NCH2", "H2NH2C"], "[CH2]N", 0.2),
    _s(["CH2CN", "NCCH2", "NCH2C"], "[CH2]C#N", 0.2),
    _s(["CH2Cl", "ClCH2", "ClH2C"], "[CH2]Cl", 0.2),
    _s(["CH2Br", "BrCH2", "BrH2C"], "[CH2]Br", 0.2),
    _s(["OCH2Ph"], "[O]Cc1ccccc1", 0.2),
    _s(["B(OH)2", "(HO)2B"], "[B](O)O", 0.3),
    _s(["Bpin", "pinB"], "[B]1OC(C)(C)C(C)(C)O1", 0.2),
]

ABBREVIATIONS: Dict[str, Substitution] = {
    abbr: sub for sub in SUBSTITUTIONS for abbr in sub.abbrvs
}

# Element valences used by the condensed-formula DFS (`abbrs.py:220-224`).
VALENCES: Dict[str, List[int]] = {
    "H": [1], "Li": [1], "Be": [2], "B": [3], "C": [4], "N": [3, 5],
    "O": [2], "F": [1], "Na": [1], "Mg": [2], "Al": [3], "Si": [4],
    "P": [5, 3], "S": [6, 2, 4], "Cl": [1], "K": [1], "Ca": [2],
    "Br": [1], "I": [1],
}

from molnextr_tpu_torch.chem.mol import PERIODIC_TABLE

ELEMENTS: List[str] = [e for e in PERIODIC_TABLE if e != "*"]

# Condensed-formula tokenizer: longest-first over known abbreviations, then
# R-groups, elements, counts, parens (`abbrs.py:247-248`).
FORMULA_REGEX = re.compile(
    "(?:"
    + "|".join(re.escape(k) for k in sorted(ABBREVIATIONS, key=len, reverse=True))
    + r"|R[0-9]*|[A-Z][a-z]+|[A-Z]|[0-9]+|\(|\))"
)
