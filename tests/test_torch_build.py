"""The port's kernel build (``repro_torch.kernels._build``) on a machine
without ``nvcc``: every CUDA source is found, a library's name follows its
source's bytes, and importing every kernel module compiles and loads
nothing.  The build itself runs on the card's machine (``chip_smoke.py``
phase 1)."""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_sources_cover_every_kernel_package():
    names = sorted(p.relative_to(_build.KERNELS_DIR).as_posix()
                   for p in _build.sources())
    assert names == ["emulator_block/csrc/emulator_block.cu",
                     "emulator_block/csrc/emulator_block_unified.cu",
                     "flash_attention/csrc/flash_attention.cu",
                     "linear_scan/csrc/linear_scan.cu",
                     "xbar_mac/csrc/xbar_mac.cu"]
    for p in _build.sources():                 # a plain C entry point each
        assert 'extern "C"' in p.read_text()


def test_library_name_follows_the_source_bytes(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("extern \"C\" int f() { return 0; }\n")
    first = _build._lib_path(src)
    assert first == _build._lib_path(src)
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libk_")
    src.write_text("extern \"C\" int f() { return 1; }\n")
    assert _build._lib_path(src) != first


def test_library_name_follows_the_headers_it_includes(tmp_path):
    """A header edit (direct or through another header) builds anew; a
    header the source does not include does not count."""
    (tmp_path / "common").mkdir()
    outer = tmp_path / "common" / "outer.cuh"
    inner = tmp_path / "common" / "inner.cuh"
    other = tmp_path / "common" / "other.cuh"
    outer.write_text('#pragma once\n#include "inner.cuh"\n')
    inner.write_text("#pragma once\nconstexpr int k = 1;\n")
    other.write_text("#pragma once\n")
    src = tmp_path / "k.cu"
    src.write_text('#include "common/outer.cuh"\n#include <cuda_runtime.h>\n'
                   'extern "C" int f() { return k; }\n')
    assert [p.name for p in _build._with_headers(src)] == [
        "k.cu", "outer.cuh", "inner.cuh"]
    first = _build._lib_path(src)
    other.write_text("#pragma once\nconstexpr int j = 2;\n")
    assert _build._lib_path(src) == first
    inner.write_text("#pragma once\nconstexpr int k = 2;\n")
    second = _build._lib_path(src)
    assert second != first and second.name.startswith("libk_")
    outer.write_text('#pragma once\n#include "inner.cuh"\n// edited\n')
    assert _build._lib_path(src) not in (first, second)


def test_port_kernels_include_the_shared_header():
    shared = _build.KERNELS_DIR / "common" / "csrc" / "sm90_mma.cuh"
    for pkg in ("flash_attention", "xbar_mac"):
        src = _build.KERNELS_DIR / pkg / "csrc" / f"{pkg}.cu"
        assert shared.resolve() in _build._with_headers(src)


@pytest.fixture(scope="module")
def imported_without_nvcc():
    """Import every kernel module in a fresh interpreter with no ``nvcc``
    on PATH and subprocesses refused; report what that loaded."""
    code = r"""
import importlib, json, pkgutil, shutil, subprocess, sys
assert shutil.which('nvcc') is None
def refuse(*a, **k):
    raise AssertionError('a subprocess was started at import')
subprocess.Popen = refuse
import repro_torch.kernels as K
for m in pkgutil.walk_packages(K.__path__, 'repro_torch.kernels.'):
    importlib.import_module(m.name)
from repro_torch.kernels import _build
print(json.dumps({
    'loaded': len(_build._LOADED),
    'jax': 'jax' in sys.modules,
    'modules': sorted(m for m in sys.modules
                      if m.startswith('repro_torch.kernels.')),
    'cached': {n: len(getattr(sys.modules[n], '_LIB', {})) for n in sys.modules
               if n.startswith('repro_torch.kernels.')
               and hasattr(sys.modules[n], '_LIB')}}))
"""
    env = dict(os.environ, PATH="", PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("pkg", ["emulator_block", "flash_attention",
                                 "linear_scan", "xbar_mac"])
def test_no_module_compiles_at_import(imported_without_nvcc, pkg):
    got = imported_without_nvcc
    assert got["loaded"] == 0 and not got["jax"]
    for m in ("ops", pkg):
        assert f"repro_torch.kernels.{pkg}.{m}" in got["modules"]
    assert got["cached"][f"repro_torch.kernels.{pkg}.{pkg}"] == 0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "k.cu"
    src.write_text("extern \"C\" int f() { return 0; }\n")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all([src])
