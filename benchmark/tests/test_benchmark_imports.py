"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
no reference package that a configuration names imports anything of the
port."""

import ast
import os

import pytest

from benchmark import harness

FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(harness.BENCH)
               for f in fs if f.endswith(".py"))


def top_names(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.partition(".")[0])
    return out


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: os.path.relpath(p, harness.BENCH))
def test_no_jax(path):
    assert not top_names(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in FILES if os.sep + "reference"
                                  + os.sep in p],
                         ids=lambda p: os.path.basename(p))
def test_reference_imports_nothing_of_the_port(path):
    assert not top_names(path) & {harness.PORT, "benchmark"}
    with open(path) as f:
        assert "climate_model_tpu" not in "".join(
            line for line in f if line.lstrip().startswith(("import",
                                                            "from")))


REFERENCES = sorted({harness.load_cell(w["name"]).reference
                     for w in harness.manifest()["workloads"]}
                    | {"tests.euler_reference"})


@pytest.mark.parametrize("name", REFERENCES)
def test_named_references_import_nothing_forbidden(name):
    assert "torch" in harness.reference_imports(name)
    assert harness.loaded_forbidden((), (name,)) == []


def test_the_reference_check_follows_imports(tmp_path, monkeypatch):
    """A reference whose model imports a module of the benchmark that
    imports the port and JAX is refused before it is imported."""
    cell = harness.load_cell("bl3_run")
    bench = tmp_path / "benchmark"
    (bench / "bad").mkdir(parents=True)
    (bench / "bad" / "model.py").write_text("from ..helper import f\n")
    (bench / "helper.py").write_text(
        "import climate_model_tpu_torch.cli\nfrom jax import numpy\n")
    monkeypatch.setattr(harness, "BENCH", str(bench))
    monkeypatch.setattr(harness, "ROOT", str(tmp_path))
    assert harness.loaded_forbidden((), ("bad",)) == [harness.PORT, "jax"]
    cell.reference = "bad"
    with pytest.raises(ImportError, match="imports"):
        harness.reference_of(cell)


def test_the_check_compares_whole_names():
    mods = ["climate_model_tpu_torch", "climate_model_tpu_torch.cli",
            "jaxtyping", "numpy"]
    assert harness.loaded_forbidden(mods) == []
    assert harness.loaded_forbidden(mods + ["jax.numpy"]) == ["jax"]
    assert harness.loaded_forbidden(["climate_model_tpu.core"]) == \
        ["climate_model_tpu"]
