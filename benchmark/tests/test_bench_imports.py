"""Nothing the benchmark runs imports JAX or the JAX package, judged by
whole top-level module names; the reference imports nothing of the system."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from benchmark.lib.spec import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "s2tpu", "scripts", "chip_smoke", "bench"}
SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(BENCH_DIR)) for p in SOURCES])
def test_no_forbidden_import(path):
    found = top_level_imports(path)
    assert not found & FORBIDDEN, found & FORBIDDEN
    if "reference" in path.parts:
        assert "s2tpu_torch" not in found


def test_whole_names_are_compared():
    from benchmark import run

    assert "s2tpu" not in sys.modules
    sys.modules["s2tpu_torch_lookalike.part"] = sys
    try:
        assert "s2tpu" not in run.forbidden_modules()
        sys.modules["s2tpu.part"] = sys
        assert "s2tpu" in run.forbidden_modules()
    finally:
        sys.modules.pop("s2tpu_torch_lookalike.part")
        sys.modules.pop("s2tpu.part", None)


def test_a_run_loads_no_jax():
    """The harness, every runner and the system under test, imported in a
    fresh process, leave no JAX and no s2tpu in ``sys.modules``."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import run, calibrate\n"
            "from benchmark.runners import train_corpus, serve_tiled\n"
            "import s2tpu_torch.train.trainer, s2tpu_torch.train.mae_trainer, s2tpu_torch.infer.tiled\n"
            "import s2tpu_torch.infer.quantize, s2tpu_torch.cli.train_segmentation, s2tpu_torch.cli.train_mae\n"
            "print(run.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, check=True,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.stdout.strip().splitlines()[-1] == "[]"
