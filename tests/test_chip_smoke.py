"""The GPU entry points refuse to run without a GPU and print no result."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _printed_result(stdout):
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return True
        except ValueError:
            pass
    return False


def test_device_phase_refuses_cpu():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    with pytest.raises(SystemExit) as exc:
        chip_smoke.device_phase(1)
    assert exc.value.code != 0


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_script_fails_without_gpu(script):
    r = _run(REPO / script, REPO)
    assert r.returncode != 0
    assert not _printed_result(r.stdout), r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding nothing else of the repo it cannot run."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert not _printed_result(r.stdout), r.stdout
