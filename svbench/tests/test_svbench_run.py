"""The command fails without a card, and fails without printing a
result when JAX or the JAX package is loaded."""
import json
import os
import subprocess
import sys

import pytest

from svbench import registry


def test_a_run_without_a_card_fails():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = subprocess.run(
        [sys.executable, os.path.join(registry.HERE, "run.py"),
         "--workload", "hifi.germline", "--seed", str(2**31 + 7),
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
        cwd=registry.ROOT, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_no_result_when_the_jax_package_is_loaded(monkeypatch, capsys):
    from svbench import run
    result = dict(correct=True, attempted=1, failed=0, metrics={},
                  device={}, checks={"calls_differing": dict(value=0,
                                                             limit=0)})
    assert run.emit(result) == 0
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1])["correct"]
    assert out.err.strip().splitlines()[-1].startswith("check ")
    monkeypatch.setitem(sys.modules, "cutesv_tpu", object())
    assert run.emit(result) == 3
    out = capsys.readouterr()
    assert out.out == "" and "cutesv_tpu" in out.err
