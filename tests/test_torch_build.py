"""The boundary between the port's Python wrappers and its CUDA sources,
checked without a compiler: every ctypes mirror of a kernel's argument
struct (and the WTA kernel's plain argument list) against the declaration
in the ``.cu`` file, field for field, and the build cache's key, which must
change when a header that a source includes changes."""
import ctypes
import re
import shutil

import pytest

from repro_torch.kernels import _build, stdp_update, threefry, tnn_column, tnn_wave, wta

_C_SCALARS = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
              "float": ctypes.c_float, "unsigned": ctypes.c_uint}


def _source(name):
    text = (_build.CSRC / name).read_text()
    return re.sub(r"//[^\n]*", "", text)


def _defines(text):
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"#define\s+(\w+)\s+(\d+)", text)}


def _c_type(decl_type, pointer):
    """The ctypes type a C declaration maps to on this ABI."""
    if pointer:
        return ctypes.c_void_p
    return _C_SCALARS[decl_type.replace("const", "").strip()]


def _struct_fields(text, struct):
    """[(name, ctypes type, array length or None)] of ``struct`` in order."""
    body = re.search(r"struct\s+%s\s*\{(.*?)\};" % struct, text, re.S).group(1)
    consts = _defines(text)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        head = re.match(r"((?:const\s+)?[\w ]+?)\s*(\*?)\s*(\w+(?:\[\w+\])?(?:\s*,\s*\w+(?:\[\w+\])?)*)$",
                        " ".join(decl.split()))
        assert head, decl
        ctype = _c_type(head.group(1), bool(head.group(2)))
        for item in head.group(3).split(","):
            m = re.match(r"\s*(\w+)(?:\[(\w+)\])?", item)
            n = m.group(2)
            fields.append((m.group(1), ctype,
                           None if n is None else consts.get(n, int(n) if n.isdigit() else None)))
    return fields


def _ctypes_fields(cls):
    out = []
    for name, t in cls._fields_:
        if issubclass(t, ctypes.Array):
            out.append((name, t._type_, t._length_))
        else:
            out.append((name, t, None))
    return out


@pytest.mark.parametrize("source,struct,mirror", [
    ("tnn_wave.cu", "WaveArgs", tnn_wave._WaveArgs),
    ("tnn_column.cu", "ColumnArgs", tnn_column._ColumnArgs),
    ("stdp_update.cu", "StdpArgs", stdp_update._StdpArgs),
])
def test_launch_struct_matches_the_source(source, struct, mirror):
    """Same names, same order, same C types, same array lengths: ctypes then
    lays the struct out as the compiler does."""
    want = _struct_fields(_source(source), struct)
    assert len(want) >= 10
    assert _ctypes_fields(mirror) == want


def test_wrapper_constants_match_the_sources():
    assert _defines(_source("tnn_wave.cu"))["TNN_MAX_LAYERS"] == tnn_wave.MAX_LAYERS
    assert (_defines(_source("tnn_column.cu"))["TNN_COLUMN_MAX_THREADS"]
            == tnn_column.MAX_THREADS)
    stdp = _defines(_source("stdp_update.cu"))
    assert stdp["TNN_STDP_MAX_TABLE"] == stdp_update.MAX_TABLE
    assert stdp["TNN_STDP_MAX_THREADS"] == stdp_update.MAX_THREADS
    assert stdp["TNN_STDP_MAX_STAGES"] == stdp_update.MAX_STAGES
    assert stdp["TNN_STDP_VOLLEYS"] == stdp_update.VOLLEYS
    assert stdp_update.STAGES <= stdp_update.MAX_STAGES
    w = _defines(_source("wta.cu"))
    assert w["TNN_WTA_MAX_Q"] == wta.MAX_Q
    assert w["TNN_WTA_MAX_TILE_BYTES"] == wta.MAX_TILE_BYTES


def test_wta_launch_signature_matches_the_source():
    text = _source("wta.cu")
    params = re.search(r"int\s+tnn_wta_launch\s*\(([^)]*)\)", text).group(1)
    want = []
    for p in params.split(","):
        p = " ".join(p.split())
        m = re.match(r"((?:const\s+)?[\w ]+?)\s*(\*?)\s*\w+$", p)
        want.append(_c_type(m.group(1), bool(m.group(2))))
    assert wta.LAUNCH_ARGTYPES == want


def test_threefry_launch_signature_and_constants_match_the_source():
    """The threefry wrapper's ctypes argument list is the C launch
    function's, and its block size is one the kernel takes."""
    text = _source("threefry.cu")
    for fn, argtypes in (("tnn_threefry_uniform_launch", threefry.LAUNCH_ARGTYPES),
                         ("tnn_threefry_nested_launch", threefry.NESTED_ARGTYPES),
                         ("tnn_threefry_hash_launch", threefry.HASH_ARGTYPES)):
        params = re.search(r"int\s+%s\s*\(([^)]*)\)" % fn, text).group(1)
        want = []
        for p in params.split(","):
            m = re.match(r"((?:const\s+)?[\w ]+?)\s*(\*?)\s*\w+$", " ".join(p.split()))
            want.append(_c_type(m.group(1), bool(m.group(2))))
        assert argtypes == want, fn
    max_threads = _defines(text)["TNN_TF_MAX_THREADS"]
    assert 32 <= threefry.THREADS <= max_threads and threefry.THREADS % 32 == 0
    assert [p.name for p in _build.sources("threefry")] == ["threefry.cu"]


def test_sources_follow_includes():
    names = [p.name for p in _build.sources("stdp_update")]
    assert names == ["stdp_update.cu", "tnn_common.cuh", "tnn_async.cuh"]
    assert [p.name for p in _build.sources("wta")] == ["wta.cu", "tnn_async.cuh"]
    for name in ("tnn_wave", "tnn_column"):
        assert "tnn_common.cuh" in [p.name for p in _build.sources(name)]


def test_library_path_changes_with_an_included_header(tmp_path):
    """An edited header must not load a stale library: the cache key covers
    every header a source includes, and only those."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    before = {n: _build.library_path(n, csrc)
              for n in ("tnn_wave", "tnn_column", "stdp_update", "wta")}
    assert before == {n: _build.library_path(n) for n in before}
    header = csrc / "tnn_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n, csrc) for n in before}
    for name in ("tnn_wave", "tnn_column", "stdp_update"):
        assert after[name] != before[name], name
        assert after[name].name == f"lib{name}.so"
    assert after["wta"] == before["wta"]  # does not include the header
    # a header included only through another header counts too
    (csrc / "extra.cuh").write_text("#pragma once\n")
    header.write_text('#include "extra.cuh"\n' + header.read_text())
    base = _build.library_path("tnn_column", csrc)
    (csrc / "extra.cuh").write_text("#pragma once\n// changed\n")
    assert _build.library_path("tnn_column", csrc) != base


def test_library_path_changes_with_the_async_header(tmp_path):
    """The async-copy header is part of the streaming kernels' builds only."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    names = ("tnn_wave", "tnn_column", "stdp_update", "wta")
    before = {n: _build.library_path(n, csrc) for n in names}
    header = csrc / "tnn_async.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n, csrc) for n in names}
    assert [n for n in names if after[n] != before[n]] == ["stdp_update", "wta"]
