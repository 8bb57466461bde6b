"""``repro_torch.train.trainer`` against ``repro.train.trainer``.

The train step on f32 losses from the same state and batches: params,
optimizer state and metrics at rtol 1e-5, with microbatches 1 and 4, by
scan and unrolled (``repro``'s ``tests/test_train.py:59-87``); 20 steps
of the reduced two-tower (bf16 towers) with ``adamw`` (cosine schedule,
weight decay, clipping) from ``repro``'s parameters: the first step's
gradient norm within 1e-3 relative (same parameters), the loss history
within 5e-3 relative and each parameter leaf's move at cosine ≥ 0.98.
Adam turns bf16 gradient noise into full-size steps (its first step is
sign(g), so a near-zero coordinate whose sign flips moves by a whole
learning rate), so trajectories are held looser than one evaluation's
loss and gradients (ROADMAP §C).  Then the state helpers and the loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs import registry as r_reg  # noqa: E402
from repro.data import batches as r_batches  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import recsys as RR  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro.train import trainer as RT  # noqa: E402
from repro_torch.configs import registry as p_reg  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import recsys as PR  # noqa: E402
from repro_torch.train import optimizer as PO  # noqa: E402
from repro_torch.train import trainer as PT  # noqa: E402

CPU = "cpu"
F32_RTOL = 1e-5
LOSS_RTOL = 1e-3
#: a 20-step Adam trajectory of a bf16 model (ROADMAP §C)
HISTORY_RTOL = 5e-3
MOVE_COS = 0.98


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_state_close(got, want, rtol=F32_RTOL, atol=1e-7):
    g, w = PO.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _mse(params, batch, xp):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = xp.mean(xp.square(pred - batch["y"]))
    return loss, {"mse": loss}


def _linear_problem(seed=0):
    rng = np.random.default_rng(seed)
    batch = {"x": rng.standard_normal((8, 4)).astype(np.float32),
             "y": rng.standard_normal((8,)).astype(np.float32)}
    params = {"w": rng.standard_normal((4,)).astype(np.float32),
              "b": np.zeros((), np.float32)}
    return params, batch


@pytest.mark.parametrize("tx_name", ["sgd", "adamw"])
@pytest.mark.parametrize("microbatches,unroll", [(1, False), (4, False),
                                                 (4, True)])
def test_train_step_matches_repro(tx_name, microbatches, unroll):
    params, batch = _linear_problem()
    r_tx = RO.sgd(0.1) if tx_name == "sgd" else RO.adamw(
        RO.cosine_schedule(0.1, 2, 10), weight_decay=0.1, max_grad_norm=0.5)
    p_tx = PO.sgd(0.1) if tx_name == "sgd" else PO.adamw(
        PO.cosine_schedule(0.1, 2, 10), weight_decay=0.1, max_grad_norm=0.5)
    r_state = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    r_state.update(opt=r_tx.init(r_state["params"]),
                   step=jnp.zeros((), jnp.int32))
    p_state = PT.state_from_numpy(_np_tree(r_state), CPU)
    r_step = jax.jit(RT.make_train_step(
        lambda p, b: _mse(p, b, jnp), r_tx, microbatches=microbatches,
        unroll_microbatches=unroll))
    # repro scans or unrolls the microbatches; the port has one loop for both
    p_step = PT.make_train_step(
        lambda p, b: _mse(p, b, torch), p_tx, microbatches=microbatches)
    r_batch = jax.tree_util.tree_map(jnp.asarray, batch)
    p_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(3):
        r_state, r_m = r_step(r_state, r_batch)
        p_state, p_m = p_step(p_state, p_batch)
        _assert_state_close(p_state, r_state)
        assert sorted(p_m) == sorted(r_m) == ["grad_norm", "loss", "mse"]
        for k in r_m:
            np.testing.assert_allclose(float(p_m[k]), float(r_m[k]),
                                       rtol=F32_RTOL)
    assert p_state["step"].dtype == torch.int32 and int(p_state["step"]) == 3


def test_microbatch_grads_equal_full_batch():
    """Accumulated microbatch grads == single-batch grads (mean of
    equal-sized micro MSEs), for 2, 4 and 8 microbatches."""
    params, batch = _linear_problem(1)
    tx = PO.sgd(0.1)
    p_batch = {k: torch.from_numpy(v) for k, v in batch.items()}

    def run(**kw):
        state = PT.state_from_numpy({"params": params, "opt": (),
                                     "step": np.int32(0)}, CPU)
        state["opt"] = tx.init(state["params"])
        step = PT.make_train_step(lambda p, b: _mse(p, b, torch), tx, **kw)
        return step(state, p_batch)[0]["params"]["w"].numpy()

    s1 = run()
    np.testing.assert_allclose(s1, run(microbatches=4), rtol=1e-5)
    for n in (2, 8):
        np.testing.assert_allclose(s1, run(microbatches=n), rtol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        run(microbatches=3)


def test_grad_transform_is_applied():
    params, batch = _linear_problem(2)
    tx = PO.sgd(1.0)
    state = PT.state_from_numpy({"params": params, "step": np.int32(0)}, CPU)
    state["opt"] = tx.init(state["params"])
    p_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    zero = PT.make_train_step(lambda p, b: _mse(p, b, torch), tx,
                              grad_transform=lambda g: PO.tree_map(
                                  torch.zeros_like, g))
    new, metrics = zero(state, p_batch)
    np.testing.assert_array_equal(new["params"]["w"].numpy(), params["w"])
    assert float(metrics["grad_norm"]) == 0.0


def test_two_tower_20_steps_match_repro():
    """The reduced two-tower, 20 steps of ``adamw`` from ``repro``'s
    parameters on the same batches."""
    r_arch, p_arch = r_reg.get_arch("two-tower-retrieval"), \
        p_reg.get_arch("two-tower-retrieval")
    r_cfg, p_cfg = r_arch.reduced, p_arch.reduced
    r_tx = RO.adamw(RO.cosine_schedule(3e-3, 5, 20), weight_decay=1e-4,
                    max_grad_norm=1.0)
    p_tx = PO.adamw(PO.cosine_schedule(3e-3, 5, 20), weight_decay=1e-4,
                    max_grad_norm=1.0)
    r_state = RT.init_state(jax.random.PRNGKey(0), lambda k: RL.init_params(
        k, RR.two_tower_spec(r_cfg)), r_tx)
    p_state = PT.state_from_numpy(_np_tree(r_state), CPU)
    start = PO.tree_leaves(p_state["params"])
    r_step = jax.jit(RT.make_train_step(
        lambda p, b: RR.two_tower_loss(p, b, r_cfg), r_tx))
    p_step = PT.make_train_step(
        lambda p, b: PR.two_tower_loss(p, b, p_cfg), p_tx)
    rng = np.random.default_rng(0)
    shape = r_arch.shape("train_batch")
    r_hist, p_hist = [], []
    for i in range(20):
        batch = _np_tree(r_batches.make_batch(rng, r_arch, shape))
        r_state, r_m = r_step(r_state, batch)
        p_state, p_m = p_step(p_state, PT.state_from_numpy(batch, CPU))
        r_hist.append(float(r_m["loss"]))
        p_hist.append(float(p_m["loss"]))
        if i == 0:
            np.testing.assert_allclose(float(p_m["grad_norm"]),
                                       float(r_m["grad_norm"]),
                                       rtol=LOSS_RTOL)
    np.testing.assert_allclose(p_hist, r_hist, rtol=HISTORY_RTOL)
    assert p_hist[-1] < p_hist[0]
    assert int(p_state["step"]) == 20
    r_leaves = jax.tree_util.tree_leaves(r_state["params"])
    for s, g, w in zip(start, PO.tree_leaves(p_state["params"]), r_leaves):
        dg = (g - s).double().numpy().ravel()
        dw = (np.asarray(w, np.float64) - s.double().numpy()).ravel()
        cos = dg @ dw / (np.linalg.norm(dg) * np.linalg.norm(dw))
        assert cos >= MOVE_COS, cos


def test_init_and_abstract_state():
    cfg = p_reg.get_arch("fm").reduced
    spec = PR.fm_spec(cfg)
    tx = PO.adamw(1e-3, weight_decay=1e-4, max_grad_norm=1.0)
    state = PT.init_state(torch.Generator().manual_seed(0),
                          lambda g: PL.init_params(g, spec, CPU), tx)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    assert isinstance(state["opt"][1], PO.ScaleByAdamState)
    abstract = PT.abstract_state(PL.abstract_params(spec), tx)
    a, c = PO.tree_leaves(abstract), PO.tree_leaves(state)
    assert [(x.shape, x.dtype) for x in a] == [(x.shape, x.dtype) for x in c]
    assert all(x.is_meta for x in a)
    r_abstract = RT.abstract_state(RL.abstract_params(RR.fm_spec(
        r_reg.get_arch("fm").reduced)), RO.adamw(
            1e-3, weight_decay=1e-4, max_grad_norm=1.0))
    assert ([tuple(x.shape) for x in a]
            == [x.shape for x in jax.tree_util.tree_leaves(r_abstract)])


def test_state_from_numpy_maps_repro_state_types():
    params = {"w": np.ones((2, 3), np.float32), "l": [{"b": np.zeros(3)}]}
    for r_tx in (RO.adamw(1e-3, weight_decay=1e-4, max_grad_norm=1.0),
                 RO.adamw(1e-3, quantized_state=True)):
        r_state = RT.init_state(None, lambda _: jax.tree_util.tree_map(
            jnp.asarray, params), r_tx)
        got = PT.state_from_numpy(_np_tree(r_state), CPU)
        names = [type(s).__name__ for s in got["opt"] if hasattr(s, "_fields")]
        assert names and all(
            type(s) in (PO.ScaleByAdamState, PO.ScaleByAdamQ8State)
            for s in got["opt"] if hasattr(s, "_fields"))
        _assert_state_close(got, r_state, rtol=0, atol=0)


def test_run_train_loop_logs_and_checkpoints(tmp_path):
    from repro_torch.train.checkpoint import Checkpointer

    tx = PO.sgd(0.1)
    state = PT.init_state(None, lambda _: {"w": torch.zeros(2)}, tx)
    step = PT.make_train_step(
        lambda p, b: (torch.sum(torch.square(p["w"] - 4.0)), {}), tx)
    logs = []
    cfg = PT.TrainLoopConfig(total_steps=10, log_every=5,
                             checkpoint_every=4)
    ck = Checkpointer(str(tmp_path), keep=5)
    state, hist = PT.run_train_loop(step, state, iter(lambda: {}, None), cfg,
                                    checkpointer=ck, log_fn=logs.append)
    ck.wait()
    assert int(state["step"]) == 10
    assert [h["step"] for h in hist] == [5, 10]
    assert set(hist[0]) == {"step", "loss", "grad_norm"}
    assert len(logs) == 2 and logs[0].startswith("step 5: ")
    assert ck.all_steps() == [4, 8]
    # resumes from the state's step
    state, hist = PT.run_train_loop(step, state, iter(lambda: {}, None),
                                    PT.TrainLoopConfig(total_steps=12,
                                                       log_every=1),
                                    log_fn=logs.append)
    assert [h["step"] for h in hist] == [11, 12]
