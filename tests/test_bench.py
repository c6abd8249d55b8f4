"""bench.py host-side logic: phase failure handling and the helpers the
phases share (no device touched — the guarded fns here are plain Python)."""

import os

import numpy as np
import pytest


@pytest.fixture()
def bench(monkeypatch):
    monkeypatch.syspath_prepend(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    import bench as bench_mod

    return bench_mod


def test_guard_passes_result_through(bench, capsys):
    failed = []
    assert bench._guard("fine", lambda: 42.0, None, failed) == 42.0
    assert failed == []
    assert "phase 'fine' done" in capsys.readouterr().err


def test_guard_records_failure(bench, capsys):
    """A failed phase yields its default so later phases still run, and is
    recorded so the run exits non-zero; it is never retried."""
    calls = {"n": 0}

    def dead():
        calls["n"] += 1
        raise ValueError("shape mismatch")

    failed = []
    assert bench._guard("dead", dead, (None, None), failed) == (None, None)
    assert calls["n"] == 1
    assert failed == ["dead"]
    err = capsys.readouterr().err
    assert "ValueError: shape mismatch" in err
    assert "phase 'dead' FAILED" in err


def test_trajectory_rmse(bench):
    a = np.zeros((4, 3))
    b = np.zeros((5, 3))
    b[:4, 0] = [0.0, 0.0, 0.0, 0.02]
    # compared over the frames both have; RMS of [0, 0, 0, 0.02]
    assert bench.trajectory_rmse(a, b) == pytest.approx(0.01)


def test_autosize_budgets_cover_the_densest_scan(bench):
    rng = np.random.default_rng(0)

    class Log:
        scan_t = np.zeros(2)
        scan_points = np.stack([rng.uniform(-30, 30, (4000, 3)),
                                rng.uniform(-5, 5, (4000, 3))])
        scan_valid = np.ones((2, 4000), bool)

    ds, slots = bench.autosize_budgets(Log, 1.0, 4.0, qb=16)
    vox = np.unique(np.floor(Log.scan_points[0]).astype(int), axis=0)
    tiles, cnt = np.unique(np.floor(vox[:, :2] / 4.0).astype(int), axis=0,
                           return_counts=True)
    assert ds % 512 == 0 and ds >= 1.15 * len(vox)
    assert slots % 8 == 0 and slots >= 1.15 * np.ceil(cnt / 16).sum()


def test_rnd(bench):
    assert bench._rnd(None) is None
    assert bench._rnd(1.2345, 2) == 1.23
