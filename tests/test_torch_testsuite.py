"""The port's compset runner (blom_tpu_torch/tools/testsuite.py) against
tools/testsuite.py: the same COMPSETS, DEFAULT_GRID and TESTLIST, the
same --list output, its SMS and ERS for NOINY passing on the CPU, and a
PE layout other than 1x1 refused (the decomposition is not ported)."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from blom_tpu_torch.tools import testsuite as tts

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / 'tools'))
import testsuite as jts   # noqa: E402  (tools/testsuite.py)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_tables_match_tools_testsuite():
    assert tts.COMPSETS == jts.COMPSETS
    assert tts.DEFAULT_GRID == jts.DEFAULT_GRID
    assert tts.TESTLIST == jts.TESTLIST


def test_list_matches_tools_testsuite():
    def listing(*cmd):
        out = subprocess.run([sys.executable, *cmd, '--list'], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        return out.stdout
    assert listing('-m', 'blom_tpu_torch.tools.testsuite') \
        == listing('tools/testsuite.py')


@pytest.mark.parametrize('kind', ['sms', 'ers'])
def test_noiny_passes_on_cpu(kind):
    fn = getattr(tts, kind)
    assert fn('NOINY', device='cpu') == 'PASS'


def test_runner_main_on_cpu(capsys):
    assert tts.main(['--cpu', '--category', 'restart']) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in out] \
        == ['ERS_Ld3.NOINY', 'ERS_Ld3.NOINYAGE']
    assert all(line.split()[-1] == 'PASS' for line in out)


def test_pes_other_than_1x1_raise():
    with pytest.raises(NotImplementedError, match='ROADMAP item 13'):
        tts.main(['--cpu', '--pes', '2x2'])
    with pytest.raises(NotImplementedError, match='ROADMAP item 13'):
        tts.build('NOINY', pes=(1, 2), device='cpu')


def test_runner_needs_cuda_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tts.build('NOINY')
