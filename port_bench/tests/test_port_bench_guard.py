"""The import guard: nnop_tpu_torch passes, nnop_tpu and JAX do not. Each
case runs in a fresh interpreter (this test process has JAX loaded)."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

import tiny
from pbench import guard

PRELUDE = ("import sys; sys.path[:0] = [{bench!r}, {root!r}]; "
           "from pbench import guard; guard.install(); ").format(bench=tiny.BENCH_DIR,
                                                              root=tiny.ROOT)


def _python(code):
    return subprocess.run([sys.executable, "-c", PRELUDE + code], capture_output=True,
                          text=True, timeout=300, cwd=tiny.ROOT,
                          env=dict(os.environ, PYTHONPATH=""))


def test_the_port_passes():
    r = _python("import nnop_tpu_torch, nnop_tpu_torch.runtime.engine; "
                "print(guard.banned_loaded())")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


@pytest.mark.parametrize("name", ["nnop_tpu", "nnop_tpu.ops", "jax", "jaxlib", "flax"])
def test_the_jax_side_is_refused(name):
    r = _python(f"import {name}")
    assert r.returncode != 0
    assert "refuses" in r.stderr


def test_names_compare_whole():
    assert guard.banned_loaded(["nnop_tpu_torch", "nnop_tpu_torch.ops", "jaxtyping"]) == []
    assert guard.banned_loaded(["nnop_tpu.models", "jax.numpy", "torch"]) == ["jax", "nnop_tpu"]


def test_the_reference_imports_nothing_of_the_program():
    r = _python("import reference.model; print(sorted(m for m in sys.modules "
                "if m.split('.')[0] in ('nnop_tpu_torch', 'nnop_tpu', 'jax')))")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_no_card_no_result():
    r = subprocess.run([sys.executable, os.path.join(tiny.BENCH_DIR, "run.py"), "--workload",
                        "mistral-7b.train-l8192", "--seed", "3", "--seconds", "1", "--trace",
                        "0"], capture_output=True, text=True, timeout=300, cwd=tiny.ROOT,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 2 and r.stdout == ""
