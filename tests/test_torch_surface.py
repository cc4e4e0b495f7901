"""The port's surface: every public module-level def and class of the JAX
package has a counterpart of the same name in the port's module of the
same path, except the omissions listed below, each one that ROADMAP.md
names as by design. The packages are read with ast, not imported."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "simplepanorama_tpu"
PORT_PKG = ROOT / "simplepanorama_tpu_torch"

# (module, name): why the port has no counterpart
OMITTED = {
    # the TPU Pallas entry points: their kernels are the port's CUDA C++
    # kernels, launched by maxflow.grid_mincut (csrc/mincut.cu) and
    # maxflow.grid_mincut_tiled (csrc/mincut_tiled.cu); ROADMAP.md queue 2
    ("ops/maxflow.py", "grid_mincut_pallas"):
        "kernel 1, csrc/mincut.cu behind grid_mincut",
    ("ops/maxflow.py", "grid_mincut_pallas_tiled"):
        "kernel 2, csrc/mincut_tiled.cu behind grid_mincut_tiled",
    # utils/transfer.py, concurrent slab fetches over the TPU's network
    # link; ROADMAP.md: not ported by design
    ("utils/transfer.py", "fetch_slabs"): "utils/transfer.py",
}


def _public_defs(path: pathlib.Path) -> set:
    """Public module-level def and class names."""
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}


def _module_names(path: pathlib.Path) -> set:
    """Every name a module binds at its top level: defs, classes,
    assignments and imports."""
    out = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            out |= {x.id for t in targets for x in ast.walk(t)
                    if isinstance(x, ast.Name)}
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in n.names}
    return out


_MODULES = sorted(str(p.relative_to(JAX_PKG))
                  for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("module", _MODULES)
def test_jax_module_has_a_counterpart(module):
    """The port's module of the same path binds every public def and class
    of the JAX module, but for the listed omissions; a module whose every
    public name is omitted may be absent."""
    want = {name for name in _public_defs(JAX_PKG / module)
            if (module, name) not in OMITTED}
    port = PORT_PKG / module
    if not want:
        return
    assert port.exists(), f"{module} has no counterpart in the port"
    missing = sorted(want - _module_names(port))
    assert not missing, f"{module}: the port lacks {missing}"


def test_omissions_are_still_in_the_jax_package():
    """Every listed omission names a def that the JAX package still has
    (the list does not outlive what it excuses)."""
    for module, name in OMITTED:
        assert name in _public_defs(JAX_PKG / module), (module, name)


def test_the_port_imports_neither_jax_nor_the_jax_package():
    """No module of the port (nor chip_smoke.py) imports jax or
    simplepanorama_tpu."""
    files = list(PORT_PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        for n in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(n, ast.Import):
                names = [a.name for a in n.names]
            elif isinstance(n, ast.ImportFrom) and n.level == 0:
                names = [n.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "simplepanorama_tpu"), \
                    f"{path.relative_to(ROOT)} imports {name}"
