"""The roofline's operations and bytes at hand-checked shapes, and the
trace arithmetic on hand-made events."""

import pytest

from portbench import roofline as R


def test_mfcc_counts_by_hand():
    # one frame: DFT 256 x 258, mel 129 x 21, DCT 21 x 12, 2 ops a MAC
    assert R.mfcc_flops(1) == 2 * (256 * 258 + 129 * 21 + 21 * 12)
    assert R.mfcc_bytes(10) == 4 * 10 * (256 + 12 + 1)


def test_gmm_counts_by_hand():
    # rows 2, states 3, K 2, D 1: [2, 3] @ [3, 3] per slot, 2 slots
    assert R.gmm_flops(2, 3, 2, 1) == 2 * 3 * 2 * 2 * 3
    assert R.gmm_bytes(2, 3, 2, 1) == 4 * (2 * 1 + 2 * 3 * 3 + 2 * 3)


def test_bound_takes_the_larger_side():
    assert R.bound_s(165e12, 0) == pytest.approx(1.0)
    assert R.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert R.bound_s(165e9, 3.35e12) == pytest.approx(1.0)


def test_model_flops():
    assert R.scoring_model_flops(10, 4, 39) == 2 * 10 * 4 * 79
    assert R.estep_model_flops(1, 1, 1, 1) == 2 * 3 + 4 + 8


def test_profile_busy_idle_kernels_and_gaps():
    dev = [("k1", 0.0, 1.0), ("k2", 0.5, 2.0), ("Memcpy HtoD", 4.0, 5.0),
           ("k1", 6.0, 7.0)]
    host = [("pb:dense", -0.5, 2.5), ("pb:other", 3.0, 8.0),
            ("aten::copy_", 3.5, 4.5), ("aten::index", 5.2, 5.8)]
    p = R.Profile(dev, host, window_s=10.0)
    assert p.busy_s() == pytest.approx(4.0)
    assert p.idle_pct() == pytest.approx(60.0)
    assert len(p.kernels()) == 3
    assert [e[0] for e in p.kernels(within="dense")] == ["k1", "k2"]
    assert p.kernel_s("k1") == pytest.approx(2.0)
    gaps = dict((k, v) for k, v in p.idle_gaps())
    assert gaps == {"other": pytest.approx(2.0),
                    "other > aten::index": pytest.approx(1.0)}
    assert p.top_ops()[0] == ["k1", pytest.approx(2.0)]


def test_profile_without_device_events_reads_nothing():
    assert R.Profile([], [], 1.0).idle_pct() is None
