"""The port's transforms against ``repro``'s on the same inputs.

Applied to ``repro``-fitted state the port must agree to ``rtol=1e-5``;
uint8 codes may differ by one step at rounding boundaries on under 1% of
elements (the reference's own bar for two encoders); packed 1-bit words
must be bit-equal.  The port's own fits are held by quality: means
allclose, PCA subspace cosine ≥ 0.999.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.core import pca as repro_pca  # noqa: E402
from repro.core import preprocess as repro_pre  # noqa: E402
from repro.core import quantization as repro_q  # noqa: E402
from repro.core import registry as repro_registry  # noqa: E402
from repro.core.registry import build_method as repro_build_method  # noqa: E402
from repro.core.registry import method_compression_ratio as repro_ratio  # noqa: E402
from repro_torch.core import pca as port_pca  # noqa: E402
from repro_torch.core import preprocess as port_pre  # noqa: E402
from repro_torch.core import quantization as port_q  # noqa: E402
from repro_torch.core import registry as port_registry  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    basis = rng.standard_normal((24, 64)).astype(np.float32)
    docs = (rng.standard_normal((600, 24)).astype(np.float32)
            * np.linspace(3, 0.2, 24, dtype=np.float32)) @ basis \
        + rng.standard_normal((600, 64)).astype(np.float32) * 0.1 + 2.0
    queries = rng.standard_normal((80, 64)).astype(np.float32) + 0.5
    return docs, queries


def _port(cls, repro_t, **kw):
    """A port transform carrying ``repro_t``'s fitted state."""
    sd = repro_t.state_dict()
    return cls(**kw).load_state(
        {"state": {k: np.asarray(v) for k, v in sd["state"].items()},
         "fitted": sd["fitted"]}, torch.device("cpu"))


def _both(repro_t, port_t, x, kind):
    want = np.asarray(repro_t(jnp.asarray(x), kind))
    got = port_t(torch.tensor(x), kind).numpy()
    return want, got


@pytest.mark.parametrize("name", ["Center", "Normalize", "ZScore",
                                  "CenterNorm"])
@pytest.mark.parametrize("kind", ["docs", "queries"])
def test_preprocess_on_repro_state(data, name, kind):
    docs, queries = data
    rt = getattr(repro_pre, name)().fit(jnp.asarray(docs), jnp.asarray(queries))
    pt = _port(getattr(port_pre, name), rt)
    want, got = _both(rt, pt, queries if kind == "queries" else docs, kind)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("scale", [None, "paper"])
def test_pca_on_repro_state(data, scale):
    docs, queries = data
    cn = repro_pre.CenterNorm().fit(jnp.asarray(docs), jnp.asarray(queries))
    x = np.asarray(cn(jnp.asarray(docs)))
    rt = repro_pca.PCA(16, scale_components=scale).fit(jnp.asarray(x))
    pt = _port(port_pca.PCA, rt, dim=16, scale_components=scale)
    want, got = _both(rt, pt, x, "docs")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        pt.inverse(torch.from_numpy(got)).numpy(),
        np.asarray(rt.inverse(jnp.asarray(want))), rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_float_cast_matches(data, dtype):
    docs, _ = data
    rt = repro_q.FloatCast(jnp.dtype(dtype))
    pt = port_q.FloatCast(**rt.init_config())
    want = np.asarray(rt.encode(jnp.asarray(docs)).astype(jnp.float32))
    got = pt.encode(torch.from_numpy(docs)).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert pt.bits_per_dim(32.0) == rt.bits_per_dim(32.0)


def test_int8_quantizer_on_repro_state(data):
    docs, queries = data
    rt = repro_q.Int8Quantizer().fit(jnp.asarray(docs))
    pt = _port(port_q.Int8Quantizer, rt)
    for x in (docs, queries):
        want = np.asarray(rt.encode(jnp.asarray(x))).astype(int)
        got = pt.encode(torch.from_numpy(x)).numpy().astype(int)
        diff = np.abs(want - got)
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    codes = rt.encode(jnp.asarray(docs))
    np.testing.assert_allclose(
        pt.decode(torch.from_numpy(np.asarray(codes))).numpy(),
        np.asarray(rt.decode(codes)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d", [64, 45, 32])
@pytest.mark.parametrize("offset", [0.5, 0.0])
def test_onebit_words_bit_equal(data, d, offset):
    docs, _ = data
    x = docs[:, :d] - docs[:, :d].mean(0)
    rt = repro_q.OneBitQuantizer(offset)
    pt = port_q.OneBitQuantizer(offset)
    want = np.asarray(rt.encode(jnp.asarray(x)))
    got = pt.encode(torch.from_numpy(x)).numpy()
    assert want.dtype == np.uint32 and got.dtype == np.int32
    np.testing.assert_array_equal(got.view(np.uint32), want)
    np.testing.assert_array_equal(
        pt.decode(port_q.words_from_numpy(want), d).numpy(),
        np.asarray(rt.decode(jnp.asarray(want), d)))
    np.testing.assert_array_equal(
        pt(torch.from_numpy(x)).numpy(), np.asarray(rt(jnp.asarray(x))))


def test_pack_bits_sets_bit_31_and_round_trips():
    x = -np.ones((3, 64), np.float32)
    x[0, 31] = 1.0            # bit 31 of word 0 alone: the int32 sign bit
    x[1, :] = 1.0
    words = port_q.pack_bits(torch.from_numpy(x))
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(repro_q.pack_bits(jnp.asarray(x))))
    assert words[0, 0] == torch.iinfo(torch.int32).min
    signs = port_q.unpack_bits(words, 64).numpy()
    np.testing.assert_array_equal(signs, np.where(x >= 0, 1, -1))


def test_port_fits_match_repro_by_quality(data):
    docs, queries = data
    rcn = repro_pre.CenterNorm().fit(jnp.asarray(docs), jnp.asarray(queries))
    pcn = port_pre.CenterNorm().fit(torch.from_numpy(docs),
                                    torch.from_numpy(queries))
    for key in ("mean_docs", "mean_queries"):
        np.testing.assert_allclose(pcn.state[key].numpy(),
                                   np.asarray(rcn.state[key]),
                                   rtol=RTOL, atol=ATOL)
    x = np.asarray(rcn(jnp.asarray(docs)))
    rp = repro_pca.PCA(16).fit(jnp.asarray(x))
    pp = port_pca.PCA(16).fit(torch.from_numpy(x))
    w_r = np.asarray(rp.state["components"], np.float64)
    w_p = pp.state["components"].numpy().astype(np.float64)
    # cosine of the largest principal angle between the two subspaces
    cos = np.linalg.svd(w_p.T @ w_r, compute_uv=False)
    assert cos.min() >= 0.999
    np.testing.assert_allclose(pp.state["eigenvalues"].numpy(),
                               np.asarray(rp.state["eigenvalues"]),
                               rtol=1e-4)
    ri = repro_q.Int8Quantizer().fit(jnp.asarray(docs))
    pi = port_q.Int8Quantizer().fit(torch.from_numpy(docs))
    for key in ("scale", "zero"):
        np.testing.assert_allclose(pi.state[key].numpy(),
                                   np.asarray(ri.state[key]), rtol=RTOL)


def test_pca_max_fit_samples_draws_with_a_generator(data):
    docs, _ = data
    x = torch.from_numpy(docs)
    a = port_pca.PCA(8, max_fit_samples=200).fit(
        x, rng=torch.Generator().manual_seed(3))
    b = port_pca.PCA(8, max_fit_samples=200).fit(
        x, rng=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a.state["components"], b.state["components"],
                               rtol=0, atol=0)


@pytest.mark.parametrize("method,dim", [
    ("pca_int8", 128), ("pca_onebit", 245), ("fp16", 128), ("int8", 128),
    ("onebit", 128), ("pca", 64), ("original", 128),
    ("gaussian_projection", 128), ("greedy_dim_drop", 64), ("ae_full_l1", 128),
    ("contrastive", 128)])
def test_compression_ratio_equal(method, dim):
    assert port_registry.method_compression_ratio(method, dim) == \
        repro_ratio(method, dim)


@pytest.mark.parametrize("method", port_registry.METHODS)
@pytest.mark.parametrize("post", [True, False])
def test_build_method_stage_names_match(method, post):
    port = port_registry.build_method(method, 32, post=post)
    repro = repro_build_method(method, 32, post=post)
    assert port_registry.pipeline_spec(port) == [
        (type(t).__name__, t.init_config()) for t in repro.transforms]


def test_methods_and_transforms_equal_repro():
    assert port_registry.METHODS == repro_registry.METHODS
    assert sorted(port_registry.TRANSFORMS) == \
        sorted(repro_registry.TRANSFORMS)


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        port_registry.build_transform("NoSuchStage")
    with pytest.raises(ValueError, match="unknown compression method"):
        port_registry.build_method("no_such_method")


def test_pipeline_state_dict_round_trip(data):
    docs, queries = data
    pipe = port_registry.build_method("pca_int8", 16, post=False)
    pipe.fit(torch.from_numpy(docs), torch.from_numpy(queries))
    sd = pipe.state_dict()
    other = port_registry.build_pipeline_from_spec(
        port_registry.pipeline_spec(pipe)).load_state_dict(sd)
    x = torch.from_numpy(docs)
    torch.testing.assert_close(other(x), pipe(x), rtol=0, atol=0)
    assert pipe.compression_ratio(64) == pytest.approx(4 * 64 / 16)
