"""The port stands alone: no module of ``sim2real_lane_segment_tpu_torch``
and not ``chip_smoke.py`` imports JAX, Flax or the JAX package, and none
imports cv2 when it is imported (the card's machine has no cv2; the
window CLIs import it inside ``main``)."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "sim2real_lane_segment_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "sim2real_lane_segment_tpu")


def forbidden(name: str) -> bool:
    # "sim2real_lane_segment_tpu" is a string prefix of the port's own name
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def imported_names(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_scan_covers_the_port():
    assert len(SOURCES) > 15 and (ROOT / "chip_smoke.py").is_file()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [n for n in imported_names(path) if forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_prefix_trap():
    assert forbidden("sim2real_lane_segment_tpu.models")
    assert not forbidden("sim2real_lane_segment_tpu_torch.models")


def module_level_imports(path: pathlib.Path) -> list[str]:
    """Names imported by the module's own statements (not in functions)."""
    names = []
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_level_cv2(path):
    assert "cv2" not in module_level_imports(path), path.relative_to(ROOT)
