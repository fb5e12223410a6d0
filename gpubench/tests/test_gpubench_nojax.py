"""Nothing the benchmark runs loads JAX or the JAX package, and a run
that cannot run prints no result."""

import ast
import os
import shutil
import subprocess
import sys
import types

import pytest

from gpubench.harness import env, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "golf_tpu"}


def sources():
    return sorted(p for p in spec.HERE.rglob("*.py")
                  if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(
    p.relative_to(spec.HERE)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_the_check_compares_top_level_names_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "golf_tpu_torch_fake",
                        types.ModuleType("golf_tpu_torch_fake"))
    assert env.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert env.forbidden_modules() == ["jax"]


def test_the_harness_and_the_program_load_no_jax():
    code = ("import gpubench.harness.session, gpubench.harness.trace, "
            "gpubench.control, golf_tpu_torch.tasks.cli; "
            "from gpubench.harness import env; "
            "print(env.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _run(cwd, *extra):
    cmd = [sys.executable, "gpubench/run.py", "--workload",
           "golf-ss.train-b64x2s", "--seed", str(2 ** 31 + 7), "--seconds",
           "1", "--trace", "0", *extra]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_without_a_card_the_run_fails_and_prints_no_result():
    out = _run(spec.ROOT)
    assert out.returncode == 3
    assert out.stdout == ""


def test_the_benchmark_alone_fails_and_prints_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
