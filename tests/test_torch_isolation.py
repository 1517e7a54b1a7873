"""The PyTorch port stands alone: no JAX, nothing of ``fusioninfer_tpu``.

A fresh interpreter imports every module of ``fusioninfer_tpu_torch`` and
``chip_smoke.py`` and must end with no ``jax*`` and no
``fusioninfer_tpu.*`` module loaded; an AST scan checks the same
statically, including imports inside functions.  The ctypes bindings of
the CUDA entry points are checked against their C declarations, since
the kernels cannot be compiled here.
"""

import ast
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "fusioninfer_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _module_names():
    names = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for name in {_module_names()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax')"
        " or m == 'fusioninfer_tpu' or m.startswith('fusioninfer_tpu.'))\n"
        "print('LEAKED', bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr
    assert "LEAKED []" in proc.stdout, proc.stdout


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "fusioninfer_tpu"), (
                f"{path.name}:{node.lineno} imports {mod}")


def _c_params(source: str, fn: str) -> int:
    m = re.search(r'extern "C" int ' + fn + r"\((.*?)\)\s*\{", source, re.S)
    assert m, f"no extern C entry {fn}"
    return len([p for p in m.group(1).split(",") if p.strip()])


def test_ctypes_bindings_match_c_entries():
    from fusioninfer_tpu_torch.ops import _build

    assert sorted(_build.SIGNATURES) == sorted(p.name for p in _build.CSRC.glob("*.cu"))
    for name, entries in _build.SIGNATURES.items():
        source = (_build.CSRC / name).read_text()
        for fn, argtypes in entries.items():
            assert _c_params(source, fn) == len(argtypes), fn


def test_kernels_build_only_on_first_launch():
    """Importing the ops builds nothing; without nvcc the build raises
    instead of falling back."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import fusioninfer_tpu_torch.ops.flash_attention, "
        "fusioninfer_tpu_torch.ops.paged_attention\n"
        "print('BUILT' if 'fusioninfer_tpu_torch.ops._build' in sys.modules "
        "else 'LAZY')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr
    assert "LAZY" in proc.stdout
