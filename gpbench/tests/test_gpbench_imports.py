"""What the benchmark may import: nothing of JAX or the JAX package
anywhere under gpbench/, and nothing of the program in the reference.
Top-level module names are compared whole, so gp_emu_uqsa_torch does not
match gp_emu_uqsa_tpu on its prefix."""
import ast
from pathlib import Path

import pytest

HOME = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "gp_emu_uqsa_tpu"}
PROGRAM = "gp_emu_uqsa_torch"


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".", 1)[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


SOURCES = sorted(p for p in HOME.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HOME)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HOME / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)


def test_names_are_compared_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import gp_emu_uqsa_torch.gp\nfrom jax import numpy\n")
    found = top_level_imports(src)
    assert found == {"gp_emu_uqsa_torch", "jax"}
    assert found & FORBIDDEN == {"jax"}


def test_run_refuses_a_process_that_holds_jax(monkeypatch):
    import sys
    import types

    from gpbench import harness

    import gp_emu_uqsa_torch  # noqa: F401  (its name starts like the JAX package's)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax"]


def test_run_refuses_without_a_card(capsys):
    import torch

    from gpbench import run

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "cfg5.serve_fused", "--seed", "1",
                     "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "nothing measured" in out.err
