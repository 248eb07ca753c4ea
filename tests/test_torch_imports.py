"""The port's import boundary: nothing under ``src/repro_torch/`` and
nothing in ``chip_smoke.py`` imports ``jax`` or the reference package
``repro`` (``repro_torch`` itself is allowed), so the port runs on a GPU
machine without JAX.  The port's counterpart of the ``check-vbi-api``
gate, which scans ``src/repro`` only."""
import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_files_exist():
    assert len(FILES) > 20 and FILES[-1].exists()


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in FILES])
def test_no_jax_or_reference_imports(path):
    bad = [f"{i}: {line.strip()}"
           for i, line in enumerate(path.read_text().splitlines(), 1)
           if FORBIDDEN.search(line)]
    bad += [m for m in _imported_modules(path)
            if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports outside the port:\n" \
        + "\n".join(bad)


def test_boundary_check_catches_offenders():
    for line in ("import jax", "from jax import numpy", "import repro",
                 "from repro.serve import engine", "  import jax.numpy as jnp",
                 "from repro import configs"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.serve import x",
                 "from .kvcache import admit_slot", "import jaxtyping_like"):
        assert not FORBIDDEN.search(line), line
