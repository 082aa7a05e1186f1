"""The peak table (utils/roofline.PEAKS): H100 SXM data-sheet figures
keyed by JAX's device_kind, and an error for any device it does not
hold — nothing is assumed for an unknown card."""

import pytest

from pyfeaturetrack_tpu.config import create_config
from pyfeaturetrack_tpu.utils import roofline

H100 = "NVIDIA H100 80GB HBM3"


def test_h100_data_sheet_peaks():
    p = roofline.peaks_for(H100)
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert p["f32_flops"] == 67e12
    assert p["tf32_flops"] == 495e12
    assert p["bf16_flops"] == 989e12
    assert p["link_bytes_per_s"] == 450e9
    assert "data sheet" in p["source"]


@pytest.mark.parametrize("kind", ["NVIDIA H100 PCIe", "cpu",
                                  "NVIDIA A100-SXM4-80GB", "", "h100"])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        roofline.peaks_for(kind)


def test_summarize_refuses_unknown_device():
    with pytest.raises(KeyError):
        roofline.summarize({"bytes": 1e6, "flops": 1e6}, 1e-3, "cpu")


def test_summarize_against_h100_peaks():
    """A memory-bound stage: SOL = bytes / 3.35 TB/s."""
    out = roofline.summarize({"bytes": 3.35e9, "flops": 1.0}, 2e-3, H100)
    assert out["bound"] == "memory"
    assert out["sol_us"] == pytest.approx(1000.0)
    assert out["achieved_fraction"] == pytest.approx(0.5)


def test_counts_are_positive_at_the_headline_shape():
    cfg = create_config()
    for counts in (roofline.pyramid_counts(480, 640, cfg),
                   roofline.lk_counts(480, 640, 1000, cfg),
                   roofline.flow_counts(480, 640, cfg)):
        assert counts["bytes"] > 0 and counts["flops"] > 0


def test_scaling_prediction_refuses_unknown_device():
    from pyfeaturetrack_tpu.parallel.scaling import \
        predict_scaling_efficiency
    with pytest.raises(KeyError, match="no published peaks"):
        predict_scaling_efficiency(device_counts=[1, 2],
                                   device_kind="NVIDIA A100-SXM4-80GB")
