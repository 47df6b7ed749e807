"""The yardstick's counts against hand-worked values at the published
widths, and the device-trace arithmetic."""
import json

import pytest

from h100bench.harness import HERE
from h100bench.trace import busy_us, summary
from h100bench.yardstick import flops, roofline

CFG = json.loads((HERE / "configs" / "gmvae.json").read_text())
CVAE = json.loads((HERE / "configs" / "cvae.json").read_text())

B, T, TA, H, Z, V = 128, 100, 16, 512, 128, 342


def test_published_sizes():
    d = flops.dims(CFG)
    assert (d["B"], d["T"], d["Ta"], d["H"], d["Z"], d["V"]) == \
        (B, T, TA, H, Z, V)


def test_gmvae_step_by_hand():
    rec = lambda b, t: t * 2 * b * H * 3 * H          # noqa: E731
    zt = 2 * Z + 24
    fwd = (4 * rec(B, T) + 4 * 2 * B * 2 * H * Z
           + 2 * (rec(B, TA) + 2 * B * Z * 3 * H + 2 * B * Z * H)
           + 2 * B * TA * H * 3 + 2 * B * TA * H * 16
           + 2 * B * zt * H + 2 * B * zt * 3 * H
           + T * (3 * 2 * B * H * 3 * H + 2 * B * H * V))
    assert flops.train_step_flops(CFG, "gmm") == 3 * fwd
    assert round(3 * fwd / 1e9, 1) == 456.9


def test_cvae_step_by_hand():
    zt = Z + 2
    fwd = (2 * T * 2 * B * H * 3 * H + 2 * 2 * B * T * (V + 2) * 3 * H
           + 2 * 2 * B * 2 * H * Z + 2 * B * zt * H + 2 * B * zt * 3 * H
           + T * (3 * 2 * B * H * 3 * H + 2 * B * H * V))
    assert flops.train_step_flops(CVAE, "cvae") == 3 * fwd
    assert round(3 * fwd / 1e9, 1) == 397.0


def test_serve_batch_by_hand():
    f = (4 * T * 2 * 64 * H * 3 * H + 4 * 2 * 64 * 2 * H * Z
         + 2 * 64 * 280 * H + 2 * 64 * 280 * 3 * H
         + 300 * (3 * 2 * 64 * H * 3 * H + 2 * 64 * H * V))
    assert flops.serve_batch_flops(CFG, 64, 300) == f


@pytest.mark.parametrize("family,cfg", [("gmm", CFG), ("cvae", CVAE)])
def test_operation_lists_count_the_same_flops(family, cfg):
    ops = roofline.train_step_ops(cfg, family, 12_000_000)
    assert sum(f for _, f, _ in ops) == flops.train_step_flops(cfg, family)


def test_serve_operations_count_the_same_flops():
    ops = roofline.serve_batch_ops(CFG, 64, 300)
    assert sum(f for _, f, _ in ops) == flops.serve_batch_flops(CFG, 64, 300)


def test_bound_of_one_matmul_by_hand():
    # (128, 512) @ (512, 1536): 201.3 MFLOP, 4.19 MB in float32
    op = roofline._mm("x", 128, 512, 1536, 4)
    assert op[1] == 2 * 128 * 512 * 1536
    assert op[2] == 4 * (128 * 512 + 512 * 1536 + 128 * 1536)
    assert roofline.bound_seconds([op], 67e12, 3.35e12) == op[1] / 67e12
    adam = ("adam", 0.0, 4.0 * 7 * 1e6)
    assert roofline.bound_seconds([adam], 67e12, 3.35e12) == 28e6 / 3.35e12


def test_step_bound_at_the_published_widths():
    ops = roofline.train_step_ops(CFG, "gmm", 12_172_905)
    ms = roofline.bound_seconds(ops, 67e12, 3.35e12) * 1e3
    assert 6.9 < ms < 7.1      # 456.9 GFLOP / 67 TFLOP/s = 6.82 ms + bytes


def test_busy_union_counts_overlaps_once():
    ev = [("a", 0.0, 10.0), ("b", 5.0, 15.0), ("c", 20.0, 25.0),
          ("d", 21.0, 22.0)]
    assert busy_us(ev) == 20.0
    s = summary(ev + [("Memcpy HtoD", 30.0, 31.0)], 40e-6)
    assert s["busy_s"] == pytest.approx(21e-6)
    assert s["launches"] == 4 and s["events"] == 5
    assert s["idle_gaps"][0][1] == pytest.approx(5e-6)
