"""The open-loop schedule: byte-equal for a seed, and the draws of the
serving example's load generator in its order."""

import importlib.util

import numpy as np

from portbench.harness import catalog, traffic

SERVE = catalog.load_json(catalog.ROOT / "portbench/traffic/serve.json")


def test_schedule_is_byte_equal_for_a_seed():
    a = traffic.schedule(SERVE, 2.0, np.random.default_rng(2**31 + 7))
    b = traffic.schedule(SERVE, 2.0, np.random.default_rng(2**31 + 7))
    assert a[0].tobytes() == b[0].tobytes()
    assert a[1].tobytes() == b[1].tobytes()
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a[2], b[2]))
    c = traffic.schedule(SERVE, 2.0, np.random.default_rng(2**31 + 8))
    assert c[0].tobytes() != a[0].tobytes()
    # every seed offers the same number of requests
    assert len(c[0]) == len(a[0])


def test_schedule_matches_the_serving_example_loadgen():
    spec = importlib.util.spec_from_file_location(
        "portbench_loadgen_copy", catalog.ROOT / "examples_torch/loadgen.py")
    lg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lg)
    menu = tuple(lg.MenuItem(m["weight"], m["rows"], m["k"], None, "x")
                 for m in SERVE["menu"])
    want = lg.build_workload(np.random.default_rng(5), duration_s=1.5,
                             rows_per_s=SERVE["rows_per_s"], menu=menu,
                             pool_size=SERVE["pool"], zipf_alpha=0.0)
    arr, mids, rows = traffic.schedule(SERVE, 1.5, np.random.default_rng(5))
    assert arr.tobytes() == want.arrivals.tobytes()
    assert mids.tobytes() == want.menu_ids.tobytes()
    assert all(x.tobytes() == y.tobytes() for x, y in zip(rows,
                                                           want.row_ids))


def test_offered_rate_is_the_mix_rate():
    arr, mids, rows = traffic.schedule(SERVE, 5.0, np.random.default_rng(1))
    offered = sum(len(r) for r in rows) / 5.0
    assert abs(offered / SERVE["rows_per_s"] - 1.0) < 0.05
    assert arr[-1] < 5.5
