"""``repro_torch.models.layers`` against ``repro.models.layers``.

Every function of the module on the same inputs and, for layers with
parameters, on ``repro``'s parameters.  Bars: f32 computations at rtol
1e-5 (the norms, rope); bf16 computations (``dense`` and ``mlp`` at their
default compute dtype) compared in f32 at rtol = atol = 1.6e-2, since
XLA's and torch's CPU bf16 products round differently.  Fresh
initialisations draw from a ``torch.Generator``, so they are held to
``repro``'s by what they are: zeros and ones exactly, ``normal`` and
``embed`` by their std, ``glorot`` by its bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.models import layers as RL  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402
from repro_torch.train.trainer import state_from_numpy  # noqa: E402

CPU = "cpu"
F32_RTOL = 1e-5
BF16_TOL = 1.6e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _spec_tree(mod):
    return {"mlp": mod.mlp_spec((8, 16, 4)),
            "norm": mod.layernorm_spec(4),
            "rms": mod.rmsnorm_spec(4, "embed"),
            "emb": mod.ParamSpec((50, 8), ("vocab", None), "embed", 0.02),
            "g": mod.ParamSpec((6, 5), (None, "ff"), "glorot", 2.0)}


def _repro_params(seed=0):
    p = RL.init_params(jax.random.PRNGKey(seed), _spec_tree(RL))
    return p, state_from_numpy(jax.tree_util.tree_map(np.asarray, p), CPU)


def test_param_spec_default_dtype_and_checks():
    s = PL.ParamSpec((2, 3), (None, "ff"))
    assert s.dtype == torch.float32 and s.init == "normal" and s.scale == 1.0
    with pytest.raises(ValueError):
        PL.ParamSpec((2, 3), (None,))


def test_spec_tree_metadata_equal():
    p_tree, r_tree = _spec_tree(PL), _spec_tree(RL)
    assert PL.param_count(p_tree) == RL.param_count(r_tree)
    assert PL.logical_axes(p_tree) == RL.logical_axes(r_tree)
    got = PL.abstract_params(p_tree)
    want = jax.tree_util.tree_leaves(RL.abstract_params(r_tree))
    leaves = tree_leaves(got)
    assert [tuple(x.shape) for x in leaves] == [x.shape for x in want]
    assert all(x.is_meta and x.dtype == torch.float32 for x in leaves)


def test_init_params_structure_and_determinism():
    spec = _spec_tree(PL)
    a = PL.init_params(torch.Generator().manual_seed(0), spec, CPU)
    b = PL.init_params(torch.Generator().manual_seed(0), spec, CPU)
    c = PL.init_params(torch.Generator().manual_seed(1), spec, CPU)
    want = jax.tree_util.tree_leaves(RL.init_params(jax.random.PRNGKey(0),
                                                    _spec_tree(RL)))
    la, lb, lc = tree_leaves(a), tree_leaves(b), tree_leaves(c)
    assert [tuple(x.shape) for x in la] == [x.shape for x in want]
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert not torch.equal(a["emb"], c["emb"])
    assert all(x.dtype == torch.float32 and x.device.type == "cpu"
               for x in la)


def test_init_params_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PL.init_params(torch.Generator(), _spec_tree(PL))


@pytest.mark.parametrize("init,scale", [("zeros", 1.0), ("ones", 1.0),
                                        ("normal", 1.0), ("normal", 0.5),
                                        ("embed", 0.02), ("glorot", 1.0),
                                        ("glorot", 2.0)])
def test_init_statistics_match_repro(init, scale):
    shape = (512, 256)
    got = PL.init_params(torch.Generator().manual_seed(3),
                         {"w": PL.ParamSpec(shape, (None, None), init,
                                            scale)}, CPU)["w"].numpy()
    want = np.asarray(RL.init_params(
        jax.random.PRNGKey(3),
        {"w": RL.ParamSpec(shape, (None, None), init, scale)})["w"])
    assert got.dtype == want.dtype == np.float32
    if init in ("zeros", "ones"):
        np.testing.assert_array_equal(got, want)
        return
    n = got.size
    if init == "glorot":
        limit = np.sqrt(6.0 / (shape[0] + shape[1])) * scale
        assert np.abs(got).max() <= limit and np.abs(want).max() <= limit
        assert np.abs(got).max() > 0.99 * limit
        std = limit / np.sqrt(3.0)
    else:
        std = scale / np.sqrt(shape[0]) if init == "normal" else scale
    # sample std within 5 standard errors of the target, as repro's is
    for x in (got, want):
        assert abs(x.std() / std - 1) < 5 / np.sqrt(2 * n)
        assert abs(x.mean()) < 5 * std / np.sqrt(n)


def test_init_one_dim_normal_fan_in():
    got = PL.init_params(torch.Generator().manual_seed(0),
                         {"b": PL.ParamSpec((40000,), (None,))}, CPU)["b"]
    assert abs(float(got.std()) * np.sqrt(40000) - 1) < 0.03


def test_dense_and_mlp_on_repro_params():
    r_params, p_params = _repro_params()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 8)).astype(np.float32)
    for dt, jdt, tol in ((torch.float32, jnp.float32, F32_RTOL),
                         (torch.bfloat16, jnp.bfloat16, BF16_TOL)):
        got = PL.dense(p_params["mlp"][0], torch.from_numpy(x), dt)
        want = RL.dense(r_params["mlp"][0], jnp.asarray(x), jdt)
        assert got.dtype == dt
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                                   atol=tol if dt == torch.bfloat16 else 1e-6)
        got = PL.mlp(p_params["mlp"], torch.from_numpy(x),
                     compute_dtype=dt)
        want = RL.mlp(r_params["mlp"], jnp.asarray(x), compute_dtype=jdt)
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                                   atol=tol if dt == torch.bfloat16 else 1e-6)
    # default compute dtype bf16, and a non-default activation
    got = PL.mlp(p_params["mlp"], torch.from_numpy(x), act=torch.sigmoid)
    want = RL.mlp(r_params["mlp"], jnp.asarray(x), act=jax.nn.sigmoid)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_TOL,
                               atol=BF16_TOL)
    # no bias
    spec = PL.dense_spec(8, 3, None, "ff", bias=False)
    assert set(spec) == {"w"}
    w = rng.standard_normal((8, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _np(PL.dense({"w": torch.from_numpy(w)}, torch.from_numpy(x),
                     torch.float32)), x @ w, rtol=F32_RTOL, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_repro(dtype):
    r_params, p_params = _repro_params()
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 7, 4)) * 3 + 1).astype(np.float32)
    p_params = dict(p_params)
    p_params["norm"] = {"scale": torch.tensor([1.0, 2.0, 0.5, -1.0]),
                        "bias": torch.tensor([0.1, 0.0, -0.2, 0.3])}
    r_params = dict(r_params)
    r_params["norm"] = {k: jnp.asarray(v.numpy())
                        for k, v in p_params["norm"].items()}
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    tol = F32_RTOL if dtype == "float32" else BF16_TOL
    for name in ("rmsnorm", "layernorm"):
        key = "rms" if name == "rmsnorm" else "norm"
        got = getattr(PL, name)(p_params[key], xt)
        want = getattr(RL, name)(r_params[key], xj)
        assert got.dtype == xt.dtype
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=1e-6
                                   if dtype == "float32" else tol)


def test_rope_matches_repro():
    hd, s = 16, 40
    cos, sin = PL.rope_angles(hd, s, theta=10_000.0, device=CPU)
    r_cos, r_sin = RL.rope_angles(hd, s, theta=10_000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(r_cos), rtol=F32_RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(r_sin), rtol=F32_RTOL,
                               atol=1e-6)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, s, 3, hd)).astype(np.float32)
    got = PL.apply_rope(torch.from_numpy(x), cos, sin)
    want = RL.apply_rope(jnp.asarray(x), r_cos, r_sin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_RTOL,
                               atol=1e-5)
    xd = rng.standard_normal((4, 1, 3, hd)).astype(np.float32)
    pos = np.array([0, 7, 39, 12], np.int32)
    got = PL.apply_rope_at(torch.from_numpy(xd), cos, sin,
                           torch.from_numpy(pos))
    want = RL.apply_rope_at(jnp.asarray(xd), r_cos, r_sin, jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_RTOL,
                               atol=1e-5)
    # bf16 inputs keep their dtype
    got = PL.apply_rope(torch.from_numpy(x).bfloat16(), cos, sin)
    want = RL.apply_rope(jnp.asarray(x).astype(jnp.bfloat16), r_cos, r_sin)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_squared_relu_matches_repro():
    x = np.linspace(-3, 3, 41).astype(np.float32)
    np.testing.assert_array_equal(
        PL.squared_relu(torch.from_numpy(x)).numpy(),
        np.asarray(RL.squared_relu(jnp.asarray(x))))
