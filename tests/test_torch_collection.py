"""The port's test files collect where torch is not installed.

The JAX package's own CI installs no torch, and collects every file under
``tests/``. Each ``tests/test_torch_*.py`` that needs torch therefore skips
itself (``pytest.importorskip("torch")``) before it imports torch or
``repro_torch``: collected with torch hidden, the files are skipped, and
none is a collection error. This file needs no torch itself.
"""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HIDE_TORCH = ("import sys; sys.modules['torch'] = None; import pytest; "
              "sys.exit(pytest.main(sys.argv[1:]))")


def test_port_tests_skip_without_torch():
    files = sorted(p.relative_to(ROOT).as_posix()
                   for p in (ROOT / "tests").glob("test_torch_*.py")
                   if p.name != Path(__file__).name)
    assert len(files) >= 11
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, "-c", HIDE_TORCH, "--collect-only",
         "-p", "no:cacheprovider", "-p", "no:xdist", *files],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    text = out.stdout + out.stderr
    assert out.returncode in (0, 5), text      # 5: nothing left to run
    assert "error" not in text.lower(), text
    assert f"{len(files)} skipped" in text, text
