"""The port's optimizer library against ``repro.train.optimizer``.

Every transformation runs 5 steps over one nested tree (dicts, lists and
tuples) on the same gradients in both packages: updates, parameters and
optimizer state are allclose at rtol 1e-6, and the int8 moment codes of
``scale_by_adam_q8`` are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.train import optimizer as R  # noqa: E402
from repro_torch.train import optimizer as P  # noqa: E402

RTOL, ATOL = 1e-6, 1e-8
SHAPES = {"a": (3, 4), "b": [(5,), ((2, 2), (3,))], "c": {"d": (4, 2)}}
#: repro's scale_by_adam_q8 takes every tuple in its tree for a (codes,
#: scale, value) leaf (``is_leaf``), so its trees hold no tuples
SHAPES_Q8 = {"a": (3, 4), "b": [(5,), [(2, 2), (3,)]], "c": {"d": (4, 2)}}


def _tree(rng, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(rng, v) for v in shapes]
    if isinstance(shapes, tuple) and all(isinstance(s, tuple) for s in shapes):
        return tuple(_tree(rng, v) for v in shapes)
    return rng.standard_normal(shapes).astype(np.float32)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    return P.params_from_numpy(tree, torch.device("cpu"))


def _leaves_np(tree, port: bool):
    leaves = P.tree_leaves(tree) if port else jax.tree_util.tree_leaves(tree)
    return [np.asarray(x.numpy() if port else x) for x in leaves]


def _assert_trees(got, want, atol=ATOL):
    g, w = _leaves_np(got, True), _leaves_np(want, False)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == np.int8:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol)


TRANSFORMS = {
    "clip_by_global_norm": lambda M: M.clip_by_global_norm(1.0),
    "scale_by_adam": lambda M: M.scale_by_adam(),
    "scale_by_adam_q8": lambda M: M.scale_by_adam_q8(),
    "add_decayed_weights": lambda M: M.add_decayed_weights(0.1),
    "add_decayed_weights_mask": lambda M: M.add_decayed_weights(
        0.1, mask_fn=lambda p: p.shape[0] > 3),
    "scale_by_schedule": lambda M: M.scale_by_schedule(
        M.cosine_schedule(1e-2, 2, 10)),
    "add_l1_penalty": lambda M: M.add_l1_penalty(0.05),
    "chain": lambda M: M.chain(M.add_l1_penalty(0.01),
                               M.clip_by_global_norm(2.0),
                               M.scale_by_adam(),
                               M.scale_by_schedule(3e-3)),
    "adamw": lambda M: M.adamw(M.linear_warmup_schedule(1e-2, 3),
                               weight_decay=0.01, l1=1e-3, max_grad_norm=1.0),
    "adamw_q8": lambda M: M.adamw(1e-2, quantized_state=True),
    "sgd": lambda M: M.sgd(0.1),
    "sgd_momentum": lambda M: M.sgd(0.1, momentum=0.9),
    "config_cosine": lambda M: M.OptimizerConfig(warmup_steps=2,
                                                 total_steps=8).build(),
    "config_q8_wd": lambda M: M.OptimizerConfig(
        schedule="warmup_linear", weight_decay=0.1, warmup_steps=3,
        quantized_state=True).build(),
    "config_sgd_constant": lambda M: M.OptimizerConfig(
        name="sgd", schedule="constant").build(),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_five_steps_match_repro(name):
    rng = np.random.default_rng(0)
    shapes = SHAPES_Q8 if "q8" in name else SHAPES
    params = _tree(rng, shapes)
    grads = [_tree(rng, shapes) for _ in range(5)]
    rtx, ptx = TRANSFORMS[name](R), TRANSFORMS[name](P)
    rp, pp = _to_jax(params), _to_torch(params)
    rs, ps = rtx.init(rp), ptx.init(pp)
    _assert_trees(ps, rs)
    for g in grads:
        ru, rs = rtx.update(_to_jax(g), rs, rp)
        pu, ps = ptx.update(_to_torch(g), ps, pp)
        _assert_trees(pu, ru)
        _assert_trees(ps, rs)
        rp, pp = R.apply_updates(rp, ru), P.apply_updates(pp, pu)
        # p + u cancels: an ulp of the O(1) addends, not of the sum
        _assert_trees(pp, rp, atol=RTOL)


def test_q8_codes_are_int8_and_round_half_to_even():
    tx = P.scale_by_adam_q8()
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 127.0])
    codes, scale = P._q(x)
    assert codes.dtype == torch.int8
    # x / scale with scale = 127/127 + 1e-20 = 1 exactly: half to even
    assert codes.tolist() == [0, 2, 2, 0, -2, 127]
    assert float(scale) == pytest.approx(1.0)
    state = tx.init({"w": torch.zeros(6)})
    assert state.mu_q["w"].dtype == torch.int8


@pytest.mark.parametrize("sched", ["constant", "cosine", "linear"])
def test_schedules_match_repro(sched):
    make = {"constant": lambda M: M.constant_schedule(3e-4),
            "cosine": lambda M: M.cosine_schedule(1.0, 10, 110),
            "linear": lambda M: M.linear_warmup_schedule(0.5, 7)}[sched]
    rs, ps = make(R), make(P)
    steps = np.arange(0, 130, dtype=np.int32)
    want = np.asarray([rs(jnp.asarray(s)) for s in steps])
    got = np.asarray([ps(torch.tensor(s)).item() for s in steps],
                     np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert ps(torch.tensor(3)).dtype == torch.float32


def test_global_norm_and_clip_match_repro():
    # the checks of tests/test_train.py::test_clip_by_global_norm, on the port
    clip = P.clip_by_global_norm(1.0)
    out, _ = clip.update({"a": torch.full((10,), 100.0)}, (), None)
    assert float(P.global_norm(out)) == pytest.approx(1.0, rel=1e-5)
    out, _ = clip.update({"a": torch.full((10,), 1e-3)}, (), None)
    np.testing.assert_allclose(out["a"].numpy(), 1e-3, rtol=1e-5)
    tree = _tree(np.random.default_rng(1))
    np.testing.assert_allclose(float(P.global_norm(_to_torch(tree))),
                               float(R.global_norm(_to_jax(tree))),
                               rtol=RTOL)


def test_l1_penalty_and_decay_replay_repro_tests():
    # tests/test_train.py::test_l1_penalty on the port
    tx = P.chain(P.add_l1_penalty(0.5))
    params = {"w": torch.tensor([1.0, -2.0, 0.0])}
    out, _ = tx.update({"w": torch.zeros(3)}, tx.init(params), params)
    np.testing.assert_allclose(out["w"].numpy(), [0.5, -0.5, 0.0])
    # tests/test_train.py::test_weight_decay_shrinks: a zero loss, decay only
    tx = P.adamw(0.01, weight_decay=0.5)
    params = {"w": torch.ones((3, 3))}
    state = tx.init(params)
    for _ in range(20):
        upd, state = tx.update({"w": torch.zeros((3, 3))}, state, params)
        params = P.apply_updates(params, upd)
    assert float(params["w"].abs().max()) < 1.0
    with pytest.raises(ValueError):
        P.add_decayed_weights(0.1).update({"w": torch.zeros(2)}, (), None)


def test_adamw_converges_on_quadratic_with_autograd():
    # tests/test_train.py::test_adamw_converges_on_quadratic on the port
    tx = P.adamw(0.1)
    params = {"w": torch.zeros(4)}
    state = tx.init(params)
    for _ in range(200):
        w = params["w"].requires_grad_()
        torch.sum(torch.square(w - 3.0)).backward()
        upd, state = tx.update({"w": w.grad}, state, params)
        params = P.apply_updates(params, upd)
    np.testing.assert_allclose(params["w"].numpy(), 3.0, atol=1e-2)
    assert int(state[-1]) == 200 and not params["w"].requires_grad


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        P.OptimizerConfig(name="lion").build()


def test_tree_unflatten_frees_its_leaves_without_the_cycle_collector():
    """A step's gradients and updates go through ``tree_unflatten``; they
    must be freed when the last reference goes, not when the cyclic
    garbage collector next runs (on the card, three FM steps held ~27 GB
    that way)."""
    import gc
    import weakref

    leaves = [torch.zeros(3), torch.ones(2)]
    refs = [weakref.ref(x) for x in leaves]
    enabled = gc.isenabled()
    gc.disable()
    try:
        tree = P.tree_unflatten({"a": 0, "b": [0]}, leaves)
        assert torch.equal(tree["b"][0], torch.ones(2))
        del leaves, tree
        assert all(r() is None for r in refs)
    finally:
        if enabled:
            gc.enable()
