"""Nothing the harness runs loads JAX or the JAX package, the plain
reference loads nothing of the port, and a run refuses where it cannot
measure."""
import ast
import os
import shutil
import subprocess
import sys
import types

from slambench import harness

OWN = ["capture.py", "scene.py", "roofline.py", "tracer.py"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    before = harness.forbidden_modules()
    for name in ("ydorbslam_tpu_torch.slam", "jaxtyping", "flaxen", "ydorbslam_tpu_x"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == before
    for name in ("ydorbslam_tpu.geometry", "jaxlib", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(harness.forbidden_modules()) - set(before) == {
        "ydorbslam_tpu.geometry", "jaxlib", "flax.linen"}


def test_reference_and_yardstick_import_nothing_of_the_program():
    files = sorted((harness.HERE / "reference").glob("*.py")) + [harness.HERE / f for f in OWN]
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("ydorbslam_tpu_torch", "ydorbslam_tpu", "jax", "jaxlib",
                               "flax", "testing", "synthetic", "bench", "chip_smoke"), (f, mod)
    code = ("import sys; import slambench.capture, slambench.scene, slambench.roofline, "
            "slambench.tracer; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('ydorbslam_tpu_torch', 'ydorbslam_tpu', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "slambench/run.py", "--workload", "kitti00_stereo.sync", "--seed",
         "3000000019", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, env=env, timeout=300)


def test_run_refuses_without_a_card():
    r = _run(harness.ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_run_refuses_in_a_bare_checkout(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""
