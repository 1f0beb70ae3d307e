# NOTE: no XLA_FLAGS here — unit tests and smoke tests run on the single
# real CPU device.  Multi-device semantics are exercised by
# tests/md_checks.py in a subprocess with its own device-count flag, and
# the production 512-device mesh only ever exists inside
# repro.launch.dryrun processes.

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_subprocess_checks(script: str, n_devices: int = 8, timeout=900):
    """Run a check script in a fresh process with N host devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", script)],
        env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(
            f"{script} failed (rc={proc.returncode})\n"
            f"--- stdout ---\n{proc.stdout[-4000:]}\n"
            f"--- stderr ---\n{proc.stderr[-4000:]}")
    return proc.stdout


@pytest.fixture(scope="session")
def repo_root():
    return REPO


@pytest.fixture(scope="session")
def lint_clean():
    """shoal-lint pytest surface: ``lint_clean(fn, *args)`` traces the
    program, runs rules R1-R4, and raises CommLintError (an
    AssertionError rendering every finding) unless it is clean."""
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro.analysis.jaxpr_lint import lint_clean as _lint_clean

    return _lint_clean


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card and nvcc (the PyTorch port's "
        "hand-written kernels); skipped without one")
