"""The port's autoencoder against ``repro.core.autoencoder``.

On ``repro``'s own parameters the port's ``encode``, ``decode``, loss and
gradients are allclose at 1e-5.  Started from ``repro``'s initial
parameters (re-derived as ``fit`` derives them: ``split(PRNGKey(seed))``
→ ``init_autoencoder``), the port's trainer reaches ``repro``'s fitted
parameters and ``loss_history`` at rtol 1e-4: the shuffle is the same
numpy permutation in both packages.  The port's own fits (initial
weights from a ``torch.Generator``) replay the checks of
``tests/test_autoencoder.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.core import autoencoder as R  # noqa: E402
from repro_torch.core import autoencoder as P  # noqa: E402
from repro_torch.train.optimizer import params_from_numpy  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(4)
    z = rng.standard_normal((400, 8)).astype(np.float32)
    mix = rng.standard_normal((8, 48)).astype(np.float32)
    return z @ mix


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_params(got: dict, want: dict, rtol: float, atol: float):
    for part in ("enc", "dec"):
        assert len(got[part]) == len(want[part])
        for g, w in zip(got[part], want[part]):
            for key in ("w", "b"):
                np.testing.assert_allclose(g[key].detach().numpy(),
                                           np.asarray(w[key]),
                                           rtol=rtol, atol=atol)


@pytest.mark.parametrize("d_in,d_b", [(768, 128), (48, 8), (300, 64)])
@pytest.mark.parametrize("variant", ["linear", "full", "shallow_decoder"])
def test_mlp_dims_equal(variant, d_in, d_b):
    assert P._mlp_dims(variant, d_in, d_b) == R._mlp_dims(variant, d_in, d_b)


def test_table3_constants():
    assert (P.PAPER_BATCH_SIZE, P.PAPER_LR, P.PAPER_L1) == \
        (R.PAPER_BATCH_SIZE, R.PAPER_LR, R.PAPER_L1)
    assert dataclasses.asdict(P.AutoencoderConfig()) == \
        dataclasses.asdict(R.AutoencoderConfig())


@pytest.mark.parametrize("variant", ["linear", "full", "shallow_decoder"])
def test_forward_loss_and_grads_on_repro_params(data, variant):
    rp = R.init_autoencoder(jax.random.PRNGKey(1), variant, 48, 8)
    pp = params_from_numpy(_np_tree(rp), CPU)
    x = jnp.asarray(data[:64])
    xt = torch.from_numpy(data[:64])
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(P.encode(pp, xt).numpy(),
                               np.asarray(R.encode(rp, x)), **tol)
    z = R.encode(rp, x)
    np.testing.assert_allclose(
        P.decode(pp, torch.from_numpy(np.array(z))).numpy(),
        np.asarray(R.decode(rp, z)), **tol)
    loss, grads = jax.value_and_grad(R.reconstruction_loss)(rp, x)
    pp = jax.tree_util.tree_map(lambda p: p.requires_grad_(), pp)
    ploss = P.reconstruction_loss(pp, xt)
    ploss.backward()
    np.testing.assert_allclose(float(ploss.detach()), float(loss), rtol=1e-5)
    _assert_params(jax.tree_util.tree_map(lambda p: p.grad, pp), grads,
                   **tol)


@pytest.mark.parametrize("variant,l1", [
    ("linear", 0.0), ("full", 0.0), ("shallow_decoder", 0.0),
    ("shallow_decoder", R.PAPER_L1 * 1e3)])
def test_trainer_reaches_repro_fit_from_its_initial_params(data, variant,
                                                           l1):
    cfg = dict(variant=variant, bottleneck=8, l1=l1, epochs=2,
               batch_size=32, seed=3)
    ref = R.Autoencoder(R.AutoencoderConfig(**cfg)).fit(jnp.asarray(data))
    k_init, _ = jax.random.split(jax.random.PRNGKey(cfg["seed"]))
    p0 = R.init_autoencoder(k_init, variant, 48, 8)
    params, history = P._train(params_from_numpy(_np_tree(p0), CPU),
                               torch.from_numpy(data),
                               P.AutoencoderConfig(**cfg))
    assert len(history) == 2
    np.testing.assert_allclose(history, ref.loss_history, rtol=1e-4)
    _assert_params(params, ref.params, rtol=1e-4, atol=1e-6)


def test_repro_fitted_state_loads_in_the_port(data):
    ref = R.Autoencoder(R.AutoencoderConfig(
        variant="full", bottleneck=8, epochs=1)).fit(jnp.asarray(data))
    sd = ref.state_dict()
    pt = P.Autoencoder(**ref.init_config()).load_state(
        {"state": {k: np.asarray(v) for k, v in sd["state"].items()},
         "fitted": True}, CPU)
    assert sorted(pt.state) == sorted(sd["state"])
    np.testing.assert_allclose(pt(torch.from_numpy(data)).numpy(),
                               np.asarray(ref(jnp.asarray(data))),
                               rtol=1e-5, atol=1e-5)


# -- the port's own fits: the checks of tests/test_autoencoder.py ---------

@pytest.mark.parametrize("variant", ["linear", "full", "shallow_decoder"])
def test_variants_shapes(variant, data):
    ae = P.Autoencoder(P.AutoencoderConfig(variant=variant, bottleneck=8,
                                           epochs=2))
    x = torch.from_numpy(data)
    ae.fit(x)
    assert ae(x).shape == (400, 8) and ae.inverse(ae(x)).shape == (400, 48)
    assert not ae(x).requires_grad and len(ae.loss_history) == 2


def test_loss_decreases(data):
    ae = P.Autoencoder(P.AutoencoderConfig(variant="linear", bottleneck=8,
                                           epochs=30, lr=3e-3))
    ae.fit(torch.from_numpy(data))
    assert ae.loss_history[-1] < ae.loss_history[0] * 0.7


def test_linear_ae_recovers_low_rank(data):
    """8-dim latent data → 8-dim linear AE reconstructs near-perfectly."""
    ae = P.Autoencoder(P.AutoencoderConfig(variant="linear", bottleneck=8,
                                           epochs=200, lr=5e-3))
    x = torch.from_numpy(data)
    ae.fit(x)
    rec = ae.inverse(ae(x)).numpy()
    assert np.mean((rec - data) ** 2) / np.mean(data ** 2) < 0.1


def test_l1_regularization_shrinks_weights(data):
    cfg = dict(variant="linear", bottleneck=8, epochs=10, seed=1)
    x = torch.from_numpy(data)
    plain = P.Autoencoder(P.AutoencoderConfig(**cfg)).fit(x)
    l1 = P.Autoencoder(P.AutoencoderConfig(l1=1e-2, **cfg)).fit(x)
    assert float(l1.params["enc"][0]["w"].abs().mean()) < \
        float(plain.params["enc"][0]["w"].abs().mean())


def test_state_roundtrip_and_guard(data):
    x = torch.from_numpy(data)
    ae = P.Autoencoder(P.AutoencoderConfig(variant="shallow_decoder",
                                           bottleneck=8, epochs=1)).fit(x)
    assert sorted(ae.state) == ["dec0_b", "dec0_w", "enc0_b", "enc0_w",
                                "enc1_b", "enc1_w", "enc2_b", "enc2_w"]
    ae2 = P.Autoencoder(P.AutoencoderConfig(variant="shallow_decoder",
                                            bottleneck=8))
    ae2.load_state(ae.state_dict())
    torch.testing.assert_close(ae2(x), ae(x), rtol=0, atol=0)
    with pytest.raises(ValueError, match="enc0_w"):
        P.Autoencoder().load_state({"state": {}, "fitted": True})
    with pytest.raises(RuntimeError, match="not fitted"):
        P.Autoencoder()(x)


def test_nondefault_input_dim():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 100)).astype(np.float32))
    params = P.init_autoencoder(torch.Generator().manual_seed(0), "full",
                                100, 16)
    assert [layer["w"].shape[0] for layer in params["enc"]] == \
        R._mlp_dims("full", 100, 16)[:-1]
    assert np.isfinite(float(P.reconstruction_loss(params, x)))
