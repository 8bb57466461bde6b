"""The tail over all requests, the spread, the roofline byte counts on
hand-worked shapes, the peaks by card name, and the readers that turn
them into per-layer metrics."""

import math

import numpy as np
import pytest

from portbench.harness import catalog, readers, stats
from portbench.roofline import int8_ip, ivf_fused, peaks, topk_blocks


def test_tail_is_over_every_request_not_chunks():
    # ten chunks of 100: each chunk's own p95 is 0.95, the whole tail is
    # set by the one slow chunk
    lat = np.concatenate([np.linspace(0, 1, 100)] * 9 + [np.full(100, 50.0)])
    assert stats.percentile(lat, 95) == pytest.approx(50.0)
    chunk_median = np.median([np.percentile(c, 95) for c in lat.reshape(10,
                                                                         100)])
    assert chunk_median < 1.0
    assert stats.percentile(lat, 50) == pytest.approx(
        float(np.percentile(lat, 50)))


def test_failed_requests_enter_the_tail_as_infinite():
    lat = [1.0] * 90 + [math.inf] * 10
    assert stats.percentile(lat, 50) == 1.0
    assert stats.percentile(lat, 95) == math.inf


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1, 2, 3, 4, 5]) == pytest.approx((4.5 - 1.5) / 3)


def test_int8_ip_bytes_by_hand():
    # Q=1024 bf16 queries of 128, 2.1M codes of 128 bytes, a 4-byte bias a
    # query, the (1024, 2.1M) f32 scores
    b, ops, rate = int8_ip.work(1024, 2_100_000, 128)
    assert b == 262_144 + 268_800_000 + 4_096 + 8_601_600_000
    assert ops == 2.0 * 1024 * 2_100_000 * 128 and rate == "bf16"


def test_topk_blocks_bytes_by_hand():
    assert topk_blocks.block_d(10) == 1024
    assert topk_blocks.block_d(100) == 4096
    assert topk_blocks.block_d(1010) == 32768
    b, ops, _ = topk_blocks.work(1024, 2_100_000, 100)
    # 513 blocks of 4,096 columns, 100 (value, index) pairs each
    assert b == 8_601_600_000 + 1024 * 513 * 100 * 8
    assert ops == 1024 * 2_100_000


def test_ivf_fused_bytes_by_hand():
    b, ops, rate = ivf_fused.work(q=2, nprobe=3, k=4, pairs=50, list_rows=30,
                                  row_bytes=32, q_bytes=256, d=245,
                                  onebit=True)
    assert b == 30 * 36 + 2 * 256 + 2 * 3 * 8 + 2 * 4 * 8
    assert ops == 2.0 * 50 * 245 and rate == "int8"


def test_peaks_by_card_name():
    assert peaks.rates("NVIDIA H100 80GB HBM3")["bytes"] == 3.35e12
    assert peaks.rates("NVIDIA H100 PCIe")["bytes"] == 2.0e12
    t, by = peaks.bound_s(3.35e12, 1.0, 989e12, 3.35e12)
    assert t == pytest.approx(1.0) and by == "bytes"


def _ctx(**kw):
    base = dict(config={"ivf": None}, trace=None, calls=[],
                facts={"n_docs": 2_100_000, "code_dim": 128,
                       "scorer": "int8", "row_bytes": 128},
                rates=peaks.rates("H100"), spans={}, counters={},
                send_lags=[], setup={"build_s": 1.5})
    base.update(kw)
    return readers.Context(**base)


def test_roofline_readers_from_a_trace():
    b, _, _ = int8_ip.work(1024, 2_100_000, 128)
    t_bound = b / 3.35e12
    trace = {"kernels": {"void int8_ip_kernel<4>(unsigned short const*)":
                         [2 * 2 * t_bound, 2],
                         "topk_blocks_kernel(float const*)": [0.01, 2]},
             "busy_s": 0.8, "window_s": 1.0, "launches": {}}
    ctx = _ctx(trace=trace, calls=[{"n": 1024, "k": 100}] * 2)
    read = catalog.metric_reader("int8_ip_roofline")
    assert read(ctx) == pytest.approx(50.0)
    assert catalog.metric_reader("device.idle.exact")(ctx) == \
        pytest.approx(20.0)
    assert catalog.metric_reader("topk_blocks_roofline")(ctx) > 0
    # a trace that holds no such kernel gives nothing, never 0
    assert catalog.metric_reader("ivf_fused_roofline")(ctx) is None
    assert read(_ctx(trace=None, calls=[{"n": 1024, "k": 100}])) is None


def test_host_and_counter_readers():
    ctx = _ctx(spans={"search.host": [0.001, 0.003, 0.002],
                      "bulk.batch": list(np.linspace(0.01, 0.02, 101))},
               counters={"queries_served": 600, "batches_served": 40},
               send_lags=[0.0] * 95 + [0.01] * 5)
    assert catalog.metric_reader("search.host_ms.ivf")(ctx) == \
        pytest.approx(2.0)
    assert catalog.metric_reader("bulk.batch_p95_ms.exact")(ctx) == \
        pytest.approx(19.5)
    assert catalog.metric_reader("serve.rows_per_batch")(ctx) == 15.0
    assert catalog.metric_reader("setup.build_s")(ctx) == 1.5
    # 95 sends on time, 5 ten ms late: numpy's 95th lies 0.05 of the way
    assert catalog.metric_reader("serve.send_lag_p95_ms")(ctx) == \
        pytest.approx(0.5)
