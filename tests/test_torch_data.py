"""The port's synthetic KB is byte-identical to ``repro``'s from one seed."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.data import make_dpr_like_kb as repro_kb  # noqa: E402
from repro_torch.data import make_dpr_like_kb as port_kb  # noqa: E402


@pytest.mark.parametrize("kwargs", [
    dict(n_queries=40, n_docs=500, d=64, r_eff=32, seed=0),
    dict(n_queries=17, n_docs=333, d=96, r_eff=40, seed=7,
         spans_per_article=3),
    dict(n_queries=8, n_docs=64, d=768, seed=11),
    # several of the generator's 16,384-row blocks, the last one ragged
    dict(n_queries=16, n_docs=40_000, d=64, r_eff=32, seed=3),
])
def test_kb_byte_identical(kwargs):
    want = repro_kb(**kwargs)
    got = port_kb(**kwargs, device="cpu")
    for name in ("docs", "queries"):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype == np.float32
        assert g.tobytes() == w.tobytes(), name
    rel = got.relevant.numpy()
    assert rel.dtype == want.relevant.dtype
    np.testing.assert_array_equal(rel, want.relevant)
    assert got.meta == want.meta
    assert got.dim == want.dim


def test_kb_lands_on_the_requested_device():
    kb = port_kb(n_queries=4, n_docs=40, d=64, r_eff=16, device="cpu")
    assert kb.docs.device.type == "cpu" and kb.relevant.dtype == torch.int32
