"""The last public names of ``repro`` in the port, held against ``repro``'s.

``add_distractors`` byte-equal; ``simulate_storage_bytes`` equal over every
``backend_tail_stages()`` tail and the 24× / 100× pipelines;
``backend_tail_stages`` keys and stage classes equal; ``fit_apply`` at
``tests/test_preprocess.py``'s bars and allclose (rtol 1e-5) to
``repro``'s output; ``stable_hash`` and ``human_count`` equal; every port
index class satisfies the ``Index`` protocol.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro import utils as r_utils  # noqa: E402
from repro.core import preprocess as r_pre  # noqa: E402
from repro.core import quantization as r_q  # noqa: E402
from repro.core.pca import PCA as RPCA  # noqa: E402
from repro.data import synthetic as r_syn  # noqa: E402
from repro.retrieval import scorers as r_scorers  # noqa: E402
from repro_torch import utils as p_utils  # noqa: E402
from repro_torch.core import preprocess as p_pre  # noqa: E402
from repro_torch.core import quantization as p_q  # noqa: E402
from repro_torch.core.pca import PCA as PPCA  # noqa: E402
from repro_torch.data import synthetic as p_syn  # noqa: E402
from repro_torch.retrieval import (DenseIndex, Index, IndexSpec,  # noqa: E402
                                   ShardSpec, backend_tail_stages,
                                   build_index)
from repro_torch.retrieval.index import CompressedIndex  # noqa: E402
from repro_torch.retrieval.ivf import IVFFlatIndex, IVFIndex  # noqa: E402
from repro_torch.retrieval.segments import SegmentedIndex  # noqa: E402
from repro_torch.retrieval.sharded import (  # noqa: E402
    ShardedCompressedIndex, ShardedIVFIndex)

CPU = "cpu"


def test_add_distractors_byte_equal():
    r_kb = r_syn.make_dpr_like_kb(n_queries=16, n_docs=300)
    p_kb = p_syn.make_dpr_like_kb(n_queries=16, n_docs=300, device=CPU)
    want = r_syn.add_distractors(r_kb, 50, seed=3)
    got = p_syn.add_distractors(p_kb, 50, seed=3)
    assert got.docs.device.type == "cpu" and got.docs.dtype == torch.float32
    assert got.docs.numpy().tobytes() == np.asarray(want.docs).tobytes()
    assert got.meta == want.meta and got.meta["n_distractors"] == 50
    assert got.queries is p_kb.queries and got.relevant is p_kb.relevant


def test_backend_tail_stages_match():
    r_tails, p_tails = r_scorers.backend_tail_stages(), backend_tail_stages()
    assert list(p_tails) == list(r_tails)
    for name in r_tails:
        assert ([type(t).__name__ for t in p_tails[name]]
                == [type(t).__name__ for t in r_tails[name]])
        assert ([t.init_config() for t in p_tails[name]]
                == [t.init_config() for t in r_tails[name]])
    again = backend_tail_stages()          # fresh instances every call
    assert all(a is not b for name in p_tails
               for a, b in zip(p_tails[name], again[name]))


@pytest.mark.parametrize("n", [1, 1000, 1_000_003])
def test_simulate_storage_bytes_match(n):
    pipes = {name: ([], []) for name in ("24x", "100x")}
    pipes["24x"] = ([r_pre.CenterNorm(), RPCA(128), r_pre.CenterNorm(),
                     r_q.Int8Quantizer()],
                    [p_pre.CenterNorm(), PPCA(128), p_pre.CenterNorm(),
                     p_q.Int8Quantizer()])
    pipes["100x"] = ([r_pre.CenterNorm(), RPCA(245), r_q.OneBitQuantizer()],
                     [p_pre.CenterNorm(), PPCA(245), p_q.OneBitQuantizer()])
    r_tails, p_tails = r_scorers.backend_tail_stages(), backend_tail_stages()
    for name in r_tails:
        pipes[name] = (r_tails[name], p_tails[name])
    for name, (r_ts, p_ts) in pipes.items():
        want = r_q.simulate_storage_bytes(n, 768, r_ts)
        assert p_q.simulate_storage_bytes(n, 768, p_ts) == want, name
    assert p_q.simulate_storage_bytes(10, 768, pipes["24x"][1]) == 10 * 128


def test_fit_apply_at_repro_bars():
    rng = np.random.default_rng(0)
    docs = (rng.standard_normal((200, 16)) + 3.0).astype(np.float32)
    queries = (rng.standard_normal((50, 16)) - 1.0).astype(np.float32)
    for mode in ("none", "center", "norm", "center_norm", "zscore",
                 "zscore_norm"):
        d, q = p_pre.fit_apply(p_pre.PreprocessSpec(mode).build(),
                               torch.from_numpy(docs),
                               torch.from_numpy(queries),
                               rng=torch.Generator().manual_seed(0))
        assert d.shape == docs.shape and q.shape == queries.shape
        assert not bool(torch.isnan(d).any())
        rd, rq = r_pre.fit_apply(r_pre.PreprocessSpec(mode).build(),
                                 jnp.asarray(docs), jnp.asarray(queries))
        np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(q.numpy(), np.asarray(rq), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("items", [(), ("paper-dpr", 768, 0),
                                   ["two_tower", (1, 2), None, 3.5],
                                   ("ü", b"x", {"a": 1})])
def test_stable_hash_matches(items):
    assert p_utils.stable_hash(items) == r_utils.stable_hash(items)


@pytest.mark.parametrize("n", [0, 7, 999.994, 1000, 12_345, 6.5e6, 1.2e9,
                               3e12, -4.2e5, 7e15])
def test_human_count_matches(n):
    assert p_utils.human_count(n) == r_utils.human_count(n)


def test_every_port_index_satisfies_the_protocol():
    rng = np.random.default_rng(0)
    docs = torch.from_numpy(rng.standard_normal((256, 32)).astype(np.float32))
    queries = docs[:16]
    gen = torch.Generator().manual_seed(0)

    def build(**kw):
        return build_index(IndexSpec(**kw), docs, queries, rng=gen,
                           device=CPU)

    built = {
        DenseIndex: build(method="dense"),
        CompressedIndex: build(method="pca_int8", dim=16, post=False),
        IVFIndex: build(method="pca_int8", dim=16, post=False, ivf=(4, 2)),
        IVFFlatIndex: IVFFlatIndex(nlist=4, nprobe=2, kmeans_iters=2,
                                   device=CPU).fit(docs),
        SegmentedIndex: build(method="pca_int8", dim=16, post=False,
                              mutable=True),
        ShardedCompressedIndex: build(method="pca_int8", dim=16, post=False,
                                      shard=ShardSpec(shards=2)),
        ShardedIVFIndex: build(method="pca_int8", dim=16, post=False,
                               ivf=(4, 2), shard=ShardSpec(shards=2)),
    }
    for cls, idx in built.items():
        assert type(idx) is cls, (cls, type(idx))
        assert isinstance(idx, Index), cls.__name__
        assert len(idx.search(queries[:2], 3)[1][0]) == 3
    assert not isinstance(object(), Index)
