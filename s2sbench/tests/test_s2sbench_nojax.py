"""The no-JAX check compares top-level names whole, and the reference
imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from conftest import ROOT

from s2sbench import nojax


def test_top_level_names_are_compared_whole():
    names = ["s2s_tpu_torch", "s2s_tpu_torch.models", "s2s_tpu", "s2s_tpu.models.parakeet", "jax", "jax.numpy",
             "jaxlib.xla_client", "flax.linen", "jaxtyping", "flaxen", "s2s_tpu_tools"]
    assert nojax.offending(names) == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "s2s_tpu",
                                      "s2s_tpu.models.parakeet"]


def test_the_reference_imports_nothing_of_the_program_or_jax():
    for path in (ROOT / "s2sbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("s2s_tpu_torch", "s2s_tpu", "jax", "jaxlib", "flax"), (path.name, mod)


def test_loading_the_reference_loads_no_program_module():
    code = ("import sys; import s2sbench.reference.judge; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'s2s_tpu_torch', 's2s_tpu', 'jax', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
