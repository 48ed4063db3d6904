"""Import hygiene of the PyTorch/CUDA port.

blom_tpu_torch, chip_smoke.py, momtum_variants.py, ale_variants.py,
cppm_variants.py and step_ab.py import neither JAX nor anything of
blom_tpu (note that the name
blom_tpu_torch itself begins with "blom_tpu", so module names are
matched exactly), and importing every module of the package needs no
CUDA toolkit."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / 'blom_tpu_torch'
FILES = sorted(PACKAGE.rglob('*.py')) + [REPO / 'chip_smoke.py',
                                         REPO / 'momtum_variants.py',
                                         REPO / 'ale_variants.py',
                                         REPO / 'cppm_variants.py',
                                         REPO / 'step_ab.py']


def _forbidden(name: str) -> bool:
    return (name == 'jax' or name.startswith('jax.')
            or name == 'jaxlib' or name.startswith('jaxlib.')
            or name == 'blom_tpu' or name.startswith('blom_tpu.'))


def test_importing_the_package_loads_no_jax_or_blom_tpu():
    code = (
        'import importlib, pkgutil, sys\n'
        'import blom_tpu_torch\n'
        'for m in pkgutil.walk_packages(blom_tpu_torch.__path__,'
        ' "blom_tpu_torch."):\n'
        '    importlib.import_module(m.name)\n'
        'importlib.import_module("chip_smoke")\n'
        'bad = [m for m in sys.modules if m == "jax"'
        ' or m.startswith(("jax.", "jaxlib"))'
        ' or m == "blom_tpu" or m.startswith("blom_tpu.")]\n'
        'print(len([m for m in sys.modules'
        ' if m.startswith("blom_tpu_torch.")]))\n'
        'assert not bad, bad\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.mark.parametrize('path', FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax_or_blom_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or '']
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f'{path.name}:{node.lineno} imports {bad}'
