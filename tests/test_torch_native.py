"""The port's native matcher (``native.py``, ``native_src/matcher.cpp``).

* Over ``generate_corpus(seed=0)`` x ``synthetic._patterns()``: the native
  search returns the port's Python search's matches in the same order, and
  the JAX package's Python search's (in order) and native search's (as
  sets, which is all its own test holds it to).
* ``MOLNEXTR_NO_NATIVE`` selects the Python search; a broken source raises
  with the compiler's output; builds started together land in one place.
* The build root (``build_dir.py``): below a package directory that cannot
  be created, the build lands in ``$MOLNEXTR_BUILD_DIR`` when it is set and
  in the per-user cache when not, and raises naming the directories when
  none can be written; the CUDA kernels' root is chosen the same way.
"""

import os
import threading

import pytest

from molnextr_tpu_torch import build_dir, native
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


def _unwritable(tmp_path):
    """A directory below a regular file: not even root can create it."""
    (tmp_path / "f").write_text("a file")
    return str(tmp_path / "f" / "_build")


def test_a_package_root_that_cannot_be_written_builds_in_the_override(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_ROOT", _unwritable(tmp_path))
    monkeypatch.setenv("MOLNEXTR_BUILD_DIR", str(tmp_path / "override"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    path = native.build()
    assert path.startswith(str(tmp_path / "override" / "native") + os.sep)
    assert native.load(path).mnx_find_substructures.restype is not None
    assert not (tmp_path / "cache").exists()


def test_without_the_override_the_build_lands_in_the_user_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_ROOT", _unwritable(tmp_path))
    monkeypatch.delenv("MOLNEXTR_BUILD_DIR", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    path = native.build()
    assert path.startswith(str(tmp_path / "cache" / "molnextr_tpu_torch" / "native") + os.sep)
    assert os.path.exists(path)
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert build_dir.build_root(native.BUILD_ROOT, "native") == str(
        tmp_path / "home" / ".cache" / "molnextr_tpu_torch" / "native")


def test_no_writable_root_raises_naming_the_directories(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_ROOT", _unwritable(tmp_path))
    monkeypatch.delenv("MOLNEXTR_BUILD_DIR", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", _unwritable(tmp_path))
    with pytest.raises(RuntimeError, match="no writable build directory for native") as err:
        native.build()
    assert native.BUILD_ROOT in str(err.value) and "MOLNEXTR_BUILD_DIR" in str(err.value)
    monkeypatch.setenv("MOLNEXTR_BUILD_DIR", _unwritable(tmp_path))
    with pytest.raises(RuntimeError, match="no writable build directory"):
        native.build()


def test_the_kernels_build_root_is_chosen_the_same_way(tmp_path, monkeypatch):
    """No ``nvcc`` here: the root choice of ``ops/_build.py`` alone."""
    from molnextr_tpu_torch.ops import _build

    assert build_dir.build_root(_build.BUILD_ROOT, "kernels") == _build.BUILD_ROOT
    monkeypatch.setattr(_build, "BUILD_ROOT", _unwritable(tmp_path))
    monkeypatch.delenv("MOLNEXTR_BUILD_DIR", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    seen = []

    def no_nvcc():
        seen.append(1)
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert seen and (tmp_path / "cache" / "molnextr_tpu_torch" / "kernels").is_dir()
    monkeypatch.setenv("MOLNEXTR_BUILD_DIR", str(tmp_path / "override"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert (tmp_path / "override" / "kernels" / _build._source_hash()).is_dir()
