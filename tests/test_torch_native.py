"""The port's native matcher (``native.py``, ``native_src/matcher.cpp``).

* Over ``generate_corpus(seed=0)`` x ``synthetic._patterns()``: the native
  search returns the port's Python search's matches in the same order, and
  the JAX package's Python search's (in order) and native search's (as
  sets, which is all its own test holds it to).
* ``MOLNEXTR_NO_NATIVE`` selects the Python search; a broken source raises
  with the compiler's output; builds started together land in one place.
"""

import os
import threading

import pytest

from molnextr_tpu_torch import native
from molnextr_tpu_torch.chem import match
from molnextr_tpu_torch.chem.aromaticity import sanitize
from molnextr_tpu_torch.chem.smiles_parser import parse_smiles
from molnextr_tpu_torch.data.corpus import generate_corpus
from molnextr_tpu_torch.data.synthetic import _patterns

N_CORPUS = 120
EXTRA = ["CC(=O)Oc1ccccc1C(=O)O", "CC(C)(C)OC(=O)NC1CCNCC1", "CS(=O)(=O)Oc1ccccc1",
         "FC(F)(F)c1ccccc1OC", "CCOC(=O)CCC(=O)OCC", "O=C(O)CCC(=O)O", "CN(C)C(=O)c1ccccc1"]


def _mols(parse, sanitize_fn):
    out = []
    for smi in generate_corpus(N_CORPUS, seed=0) + EXTRA:
        mol = parse(smi)
        sanitize_fn(mol)
        out.append(mol)
    return out


@pytest.fixture(scope="module")
def corpus():
    return _mols(parse_smiles, sanitize)


def _search(mol, pat, af, use_native, monkeypatch, max_matches):
    if use_native:
        monkeypatch.delenv("MOLNEXTR_NO_NATIVE", raising=False)
    else:
        monkeypatch.setenv("MOLNEXTR_NO_NATIVE", "1")
    return match.find_substructures(mol, pat, af, max_matches=max_matches)


@pytest.mark.parametrize("max_matches", [1, 8, 64])
def test_native_equals_python_in_order(corpus, monkeypatch, max_matches):
    calls = []
    real = native.find_substructures_native
    monkeypatch.setattr(native, "find_substructures_native",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    found = 0
    for mol in corpus:
        for _sub, pat, af in _patterns():
            want = _search(mol, pat, af, False, monkeypatch, max_matches)
            got = _search(mol, pat, af, True, monkeypatch, max_matches)
            assert got == want
            found += len(got)
    assert found > 100 and len(calls) > 1000


def test_native_equals_the_jax_package(corpus, monkeypatch):
    import molnextr_tpu.native as jax_native
    from molnextr_tpu.chem.aromaticity import sanitize as jax_sanitize
    from molnextr_tpu.chem.match import find_substructures as jax_find
    from molnextr_tpu.chem.smiles_parser import parse_smiles as jax_parse
    from molnextr_tpu.data.synthetic import _patterns as jax_patterns

    jax_mols = _mols(jax_parse, jax_sanitize)
    monkeypatch.delenv("MOLNEXTR_NO_NATIVE", raising=False)
    pairs = list(zip(_patterns(), jax_patterns()))
    jax_lib = jax_native.get_lib()
    for mol, jmol in zip(corpus, jax_mols):
        for (_s, pat, af), (_js, jpat, jaf) in pairs:
            got = match.find_substructures(mol, pat, af, max_matches=8)
            if jax_lib is not None:
                native_sets = sorted(sorted(m.values()) for m in jax_find(jmol, jpat, jaf, 8))
                assert sorted(sorted(m.values()) for m in got) == native_sets
            monkeypatch.setattr(jax_native, "_LIB", None)
            monkeypatch.setattr(jax_native, "_TRIED", True)  # the JAX Python search
            assert got == jax_find(jmol, jpat, jaf, max_matches=8)
            monkeypatch.setattr(jax_native, "_LIB", jax_lib)


def test_no_native_switch_selects_the_python_search(corpus, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the native matcher was called")

    monkeypatch.setenv("MOLNEXTR_NO_NATIVE", "1")
    monkeypatch.setattr(native, "find_substructures_native", refuse)
    assert not native.enabled()
    _sub, pat, af = next(p for p in _patterns() if p[1].num_atoms() <= 3)
    for mol in corpus[:10]:
        match.find_substructures(mol, pat, af)
    monkeypatch.setenv("MOLNEXTR_NO_NATIVE", "")
    assert native.enabled()


def test_a_broken_source_raises_with_the_compilers_output(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("int mnx_find_substructures( { this is not C++ }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.build(str(src), str(tmp_path / "build"))
    assert "error" in str(err.value)
    assert not list((tmp_path / "build").rglob("*.so"))


def test_builds_started_together_land_in_one_place(tmp_path):
    src = os.path.join(native.SRC_DIR, "matcher.cpp")
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build(src, str(tmp_path)))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1
    lib = native.load(paths[0])
    assert lib.mnx_find_substructures.restype is not None
    assert [p.name for p in tmp_path.rglob("*") if p.is_file()] == [native.LIB_NAME]
