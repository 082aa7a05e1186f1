"""chip_smoke.py's own logic, on the CPU: the lane comparison and its
threshold explainer, the last-line contract, and the exit code — non-zero
without a GPU, non-zero when any phase fails, and a final JSON line only
when every phase passed."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

from pyfeaturetrack_tpu.config import create_config  # noqa: E402

ONE_CARD_PHASES = ("phase_config1", "phase_headline", "phase_config4",
                   "phase_serving", "phase_flow", "phase_backend",
                   "phase_kernel")


def _lanes(n=8, status=0, shift=0.0):
    x = np.arange(n, dtype=np.float64) + shift
    return x, x.copy(), np.full(n, status, np.int64)


def test_compare_lanes_equal_passes():
    res = cs.compare_lanes("eq", _lanes(), _lanes(), atol=1e-3)
    assert res["causes"] == {} and res["max_pos_diff"] == 0.0
    assert "status_mismatch=0" in res["summary"]


@pytest.mark.parametrize("case", ["status", "position", "shape"])
def test_compare_lanes_unexplained_difference_raises(case):
    got = list(_lanes())
    if case == "status":
        got[2] = got[2].copy()
        got[2][3] = -4
    elif case == "position":
        got[0] = got[0] + np.where(np.arange(8) == 5, 2e-3, 0.0)
    else:
        got = list(_lanes(9))
    with pytest.raises(cs.SmokeFailure):
        cs.compare_lanes("x", tuple(got), _lanes(), atol=1e-3)


def test_compare_lanes_position_within_tolerance_passes():
    got = _lanes(shift=5e-4)
    res = cs.compare_lanes("tol", got, _lanes(), atol=1e-3)
    assert res["max_pos_diff"] == pytest.approx(5e-4)


def test_compare_lanes_ignores_positions_of_lost_lanes():
    """Positions are compared only where both sides tracked."""
    got = _lanes(status=-4, shift=3.0)
    cs.compare_lanes("lost", got, _lanes(status=-4), atol=1e-3)


def _flip_oracle(flip_lane, param, base):
    """A fake run_oracle whose lane ``flip_lane`` changes status when
    ``param`` drops below ``base``."""
    def run(cfg, lanes):
        lanes = np.asarray(lanes)
        st = np.where((lanes == flip_lane) & (getattr(cfg, param) < base),
                      -5, 0)
        z = np.zeros(len(lanes))
        return z, z, st
    return run


@pytest.mark.parametrize("param", ["max_residue", "min_determinant",
                                   "min_displacement"])
def test_threshold_explainer_names_the_threshold(param):
    cfg = create_config()
    run = _flip_oracle(3, param, getattr(cfg, param))
    explain = cs.threshold_explainer(run, cfg, atol=1e-3)
    got = list(_lanes())
    got[2] = got[2].copy()
    got[2][3] = -5
    res = cs.compare_lanes("thr", tuple(got), _lanes(), 1e-3, explain)
    assert res["causes"] == {3: f"{param} at threshold"}


def test_threshold_explainer_leaves_other_lanes_unexplained():
    cfg = create_config()
    explain = cs.threshold_explainer(
        _flip_oracle(3, "max_residue", cfg.max_residue), cfg, atol=1e-3)
    got = list(_lanes())
    got[2] = got[2].copy()
    got[2][[3, 5]] = -5
    with pytest.raises(cs.SmokeFailure, match="1 unexplained"):
        cs.compare_lanes("thr", tuple(got), _lanes(), 1e-3, explain)


@pytest.mark.parametrize("kind,count", [("NVIDIA H100 80GB HBM3", 1),
                                        ("NVIDIA H100 80GB HBM3", 4)])
def test_final_line_is_the_contract(kind, count):
    line = cs.final_line(kind, count)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}


def test_moving_frames_translate_one_texture():
    f = cs.moving_frames(24, 32, 3, seed=1, step=(1.0, 0.0))
    assert len(f) == 3 and f[0].shape == (24, 32)
    assert f[0].dtype == np.float32
    # an integer step is an exact shift of the same texture
    np.testing.assert_allclose(f[1][:, :-1], f[0][:, 1:], atol=1e-3)


def test_timed_returns_warm_result_and_time():
    calls = []
    out, ms = cs.timed(lambda: calls.append(1) or np.ones(3))
    assert len(calls) == 2 and ms >= 0.0
    np.testing.assert_array_equal(out, np.ones(3))


@pytest.mark.parametrize("cards", [1, 4])
def test_main_fails_without_a_gpu(cards, capsys):
    """On the CPU backend phase 1 fails: non-zero exit, no last line."""
    assert cs.main(["--cards", str(cards)]) == 1
    out = capsys.readouterr().out
    assert '"ok"' not in out


class _FakeGpu:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


def _patch_phases(monkeypatch, failing=None):
    import jax
    monkeypatch.setattr(cs, "phase_device",
                        lambda jx, expect_count=1: (_FakeGpu(),
                                                    jax.devices("cpu")[0]))
    for name in ONE_CARD_PHASES + ("phase_four_cards",):
        def ok(*a, **k):
            return None

        def bad(*a, _n=name, **k):
            raise cs.SmokeFailure(f"{_n}: 3 unexplained lanes")
        monkeypatch.setattr(cs, name, bad if name == failing else ok)


@pytest.mark.parametrize("failing", ONE_CARD_PHASES)
def test_main_exits_nonzero_when_a_phase_mismatches(failing, monkeypatch,
                                                    capsys):
    _patch_phases(monkeypatch, failing)
    assert cs.main([]) == 1
    captured = capsys.readouterr()
    assert '"ok"' not in captured.out
    assert failing in captured.err


def test_main_prints_last_line_only_when_every_phase_passes(monkeypatch,
                                                            capsys):
    _patch_phases(monkeypatch)
    assert cs.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    got = json.loads(last)
    assert got["ok"] is True
    assert got["device"]["platform"] == "gpu"
    assert got["device"]["kind"] == _FakeGpu.device_kind


def test_script_alone_exits_nonzero(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script fails and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
