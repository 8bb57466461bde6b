"""A run with the timed path broken underneath comes out not correct: an
answer altered where it is produced, answers handed to the wrong rows,
and half of a batch left out (its rows given the other half's answers);
and so does one whose set-up was cut (``portbench/faults.py``)."""

import pytest
import torch

from portbench import faults, run
from portbench.harness import catalog, program
from portbench.tiny import tiny_cell, tiny_pair

CELLS = [w["name"] for w in catalog.benchmark()["workloads"]] + ["serve"]


def _broken(search, fault):
    def wrapped(self, queries, k, *a, **kw):
        v, i = search(self, queries, k, *a, **kw)
        v, i = v.clone(), i.clone()
        n = i.shape[0]
        if fault == "answer_altered":
            i[:, -1] = (i[:, 0] + 1) % len(self)
        elif fault == "rows_swapped":
            v, i = v.flip(0), i.flip(0)
        elif fault == "half_left_out":
            h = n // 2
            v[h:2 * h], i[h:2 * h] = v[:h], i[:h]
        return v, i
    return wrapped


@pytest.mark.parametrize("fault", ["answer_altered", "rows_swapped",
                                   "half_left_out"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    program.import_port()
    from repro_torch.retrieval.index import CompressedIndex
    from repro_torch.retrieval.ivf import IVFIndex
    for cls in (CompressedIndex, IVFIndex):
        monkeypatch.setattr(cls, "search", _broken(cls.search, fault))
    tiny = (tiny_pair("hotpotqa-dpr-24x", "serve", 8000) if cell == "serve"
            else tiny_cell(cell, 8000))
    r = run.run_cell(tiny, 2**31 + 303, 0.5, False, "cpu")
    assert not r["correct"], r["checks"]
    assert torch.get_num_threads() == 1


@pytest.mark.parametrize("cell,fault,number", [
    ("dpr100x-ivf.bulk", "no_rotation", "itq_gain_short"),
    ("dpr100x-ivf.bulk", "no_lloyd", "kmeans_inertia_excess"),
    ("dpr100x-ivf.bulk", "query_mean", "mean_err"),
    ("dpr24x.bulk", "query_mean", "gap_max"),
])
def test_cut_setup_is_not_correct(cell, fault, number):
    with faults.planted(fault):
        r = run.run_cell(tiny_cell(cell, 8000), 2**31 + 313, 0.5, False,
                         "cpu")
    assert not r["correct"]
    c = r["checks"][number]
    assert c["value"] > c["limit"], r["checks"]
    # the program is whole again afterwards
    assert run.run_cell(tiny_cell(cell, 8000), 2**31 + 313, 0.5, False,
                        "cpu")["correct"]
