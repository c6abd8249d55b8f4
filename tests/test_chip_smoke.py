"""chip_smoke.py: refusal without a GPU, and its comparison helpers."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


@pytest.fixture()
def smoke(monkeypatch):
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke

    return chip_smoke


def _run_script(*args, env=None, timeout=600):
    return subprocess.run(
        [sys.executable, SCRIPT, *args], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=timeout,
    )


def test_refuses_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = _run_script(env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_checks_pass_and_fail(smoke):
    c = smoke.Checks()
    assert c.at_most("a", 0.01, 0.01)
    assert c.below("b", 0.0099, 0.01)
    assert c.equal("c", 0, 0)
    assert c.note("d", 123.456)
    assert c.ok
    assert not c.below("e", 0.01, 0.01)          # strict
    assert not c.at_most("f", float("nan"), 1.0)  # non-finite never passes
    assert not c.equal("g", 1.0, 0.99)
    assert not c.ok
    line = c.line()
    assert "a=0.01<=0.01" in line and "e=0.01<0.01 FAIL" in line
    assert line.count("FAIL") == 3


def test_max_gap(smoke):
    a = np.zeros((5, 3))
    b = a.copy()
    b[3] = [0.0, 3e-4, 4e-4]
    assert smoke.max_gap_m(a, b) == pytest.approx(5e-4)
    lanes = np.zeros((2, 5, 3))
    lanes[1, 2, 0] = 2e-3
    assert smoke.max_gap_m(lanes, np.zeros((2, 5, 3))) == pytest.approx(2e-3)


@pytest.mark.parametrize("case,expect_ok", [
    ("tracks", True),
    ("transient_too_big", False),
    ("median_too_big", False),
    ("no_recontraction", False),
])
def test_windowed_contract(smoke, case, expect_ok):
    err = np.full(40, 1e-3)
    if case == "transient_too_big":
        err[10] = 0.031
    elif case == "median_too_big":
        err[:] = 0.006
    elif case == "no_recontraction":
        err[-1] = 0.0051
    else:
        err[10] = 0.029       # a bounded transient is allowed
    c = smoke.Checks()
    smoke.check_tracks_full(c, "w", err)
    assert c.ok is expect_ok


def test_run_phase_reports_exception(smoke, capsys):
    def boom(checks):
        checks.note("before", 1)
        raise RuntimeError("device lost")

    assert smoke.run_phase("p", boom) is False
    out = capsys.readouterr()
    assert "[p] FAILED" in out.out and "exception FAIL" in out.out
    assert "device lost" in out.err
    assert smoke.run_phase("q", lambda c: c.at_most("x", 1, 2)) is True


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    """The whole start-up proof, on a machine with a card."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no GPU on this machine")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = _run_script(env=env, timeout=1500)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert r.stdout.strip().splitlines()[-1].startswith('{"ok": true')
