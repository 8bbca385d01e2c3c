"""The port stands alone: it never imports JAX or the reference package.

A subprocess with ``jax`` and ``repro`` blocked imports every module of
``repro_torch`` and loads a reference blob whose NamedTuple names a
``repro.…`` class (it resolves to the port's counterpart); an AST scan of the port and of ``chip_smoke.py``
finds no such import.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.optim.adamw import OptState
from repro.storage import serde as jserde

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "repro")

_CHILD = r"""
import importlib, pkgutil, sys

BANNED = {banned!r}


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("blocked: " + name)
        return None


sys.meta_path.insert(0, Block())
import repro_torch

names = ["repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
]
for name in names:
    importlib.import_module(name)
from repro_torch.storage import serde

value = serde.loads(sys.stdin.buffer.read())
from repro_torch.optim.adamw import OptState

assert type(value) is OptState and tuple(value) == (1, 2, 3), value
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax_or_reference():
    blob = jserde.dumps(OptState(1, 2, 3))
    assert b"repro.optim.adamw:OptState" in blob
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(banned=BANNED)],
        input=blob, capture_output=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr.decode()
    assert int(proc.stdout) > 20  # every module was imported


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    [ROOT / "chip_smoke.py", ROOT / "chip_flash_tiles.py", ROOT / "chip_train_lr.py",
     ROOT / "chip_dist4.py", ROOT / "chip_flash_f32.py",
     *(ROOT / "src" / "repro_torch").rglob("*.py")]
), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_banned_import_in_source(path):
    assert path.exists()
    banned = sorted(set(_imported_roots(path)) & set(BANNED))
    assert not banned, f"{path} imports {banned}"
