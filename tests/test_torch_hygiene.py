"""What the port may and may not depend on, and where it runs.

* ``src/repro_torch`` and ``chip_smoke.py`` never import ``jax`` (not even
  inside a function) nor anything of the JAX package ``repro``: the bridge
  from the JAX side lives in the test files alone.
* The entry points run on the card unless the caller passes
  ``device="cpu"``; without a card they raise instead of falling back.
* Importing the kernel module compiles nothing.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_port_imports_neither_jax_nor_the_jax_package():
    assert len(PORT_FILES) > 20
    bad = [f"{p.relative_to(ROOT)}:{line}: {mod}"
           for p in PORT_FILES for line, mod in _imports(p)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_the_import_walk_covers_every_package():
    """Every package of the port is walked, the checkpoint and program
    cache packages among them."""
    pkgs = {p.parent.name for p in PORT_FILES}
    want = {d.name for d in (ROOT / "src" / "repro_torch").iterdir()
            if (d / "__init__.py").exists()}
    assert {"checkpoint", "cache"} <= want and want <= pkgs


def test_the_import_walk_covers_the_mesh_modules():
    """The mesh layer's modules (the rules, the mesh, the rank harness)
    are walked, and the rank harness's body imports no JAX either."""
    port = ROOT / "src" / "repro_torch"
    for rel in ("dist/sharding.py", "dist/__init__.py", "launch/mesh.py",
                "testing.py"):
        assert port / rel in PORT_FILES, rel
    from repro_torch import testing
    body = ast.parse(testing._PREAMBLE + testing._EPILOGUE)
    mods = [a.name for n in ast.walk(body) if isinstance(n, ast.Import)
            for a in n.names] + [n.module for n in ast.walk(body)
                                 if isinstance(n, ast.ImportFrom)]
    assert mods and not [m for m in mods
                         if m.split(".")[0] in FORBIDDEN], mods


def test_the_import_walk_catches_what_it_must(tmp_path):
    src = ("import jax.numpy as jnp\nfrom repro.core import ir\n"
           "def f():\n    import jaxlib\n    __import__('repro.serve')\n"
           "from repro_torch.core import tapir\nfrom . import x\n")
    p = tmp_path / "probe.py"
    p.write_text(src)
    mods = [m for _, m in _imports(p)]
    assert [m for m in mods if m.split(".")[0] in FORBIDDEN] == [
        "jax.numpy", "repro.core", "jaxlib", "repro.serve"]


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.base import get_model
    from repro_torch.models.transformer import DenseLM
    from repro_torch.serve import ServingEngine
    cfg = get_smoke("qwen2_5_3b")
    with pytest.raises(RuntimeError, match="cuda"):
        DenseLM(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        get_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_cli.main(["--smoke"])
    model = get_model(cfg, device="cpu")
    assert model.device.type == "cpu"
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(model, batch=2, max_len=32)


def test_kernel_module_imports_without_nvcc_and_builds_nothing():
    code = ("import os, shutil\n"
            "from repro_torch.kernels.fused_matmul import kernel, ops\n"
            "assert shutil.which('nvcc') is None\n"
            "assert kernel._lib is None and ops.launches == 0\n"
            "print(kernel.SOURCE.exists(), kernel.BUILD_DIR)\n")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["True", str(ROOT / "build")]
