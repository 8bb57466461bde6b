"""LM training in ``repro_torch`` against ``repro``: Adam steps through
``make_train_step`` and checkpoints that cross between the packages.

- 5 steps of ``adamw`` (cosine schedule, weight decay, clipping) with 1
  and 2 microbatches on phi4-mini's and qwen3-moe's REDUCED configs, each
  port step from ``repro``'s state before it (loss within 1e-3 relative,
  each leaf's move at cosine ≥ 0.98), and a free 5-step run of the dense
  model with its loss history within 5e-3 relative (the bars of the
  two-tower run);
- an LM train state checkpointed by each package and restored by the
  other, bit for bit.

The model helpers are ``test_torch_models_lm``'s.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from test_torch_models_lm import (_repro_params, _to_port,  # noqa: E402
                                  _tokens, CPU, LOSS_RTOL)
from repro.configs import registry as r_reg  # noqa: E402
from repro.data import batches as r_batches  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro.train import trainer as RTR  # noqa: E402
from repro.train.checkpoint import Checkpointer as RCheckpointer  # noqa: E402
from repro_torch.configs import registry as p_reg  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.train import optimizer as PO  # noqa: E402
from repro_torch.train import trainer as PTR  # noqa: E402
from repro_torch.train.checkpoint import Checkpointer  # noqa: E402

#: a free 5-step Adam run's loss history, and one Adam step's moves from
#: the same state (the two-tower run's bars, ROADMAP §C)
HISTORY_RTOL = 5e-3
MOVE_COS = 0.98


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "qwen3-moe-30b-a3b"])
def test_adam_steps_match_repro(arch, microbatches):
    """5 steps of ``adamw`` (cosine schedule, weight decay, clipping)
    through ``make_train_step`` from ``repro``'s initial state, on
    ``make_batch``'s lm_train batches.  Each port step starts from
    ``repro``'s state before it: loss within 1e-3 relative, each leaf's
    move at cosine ≥ 0.98.  A 5-step run of the port's own
    (phi4-mini): loss history within 5e-3 relative.  Free
    runs are not held leaf by leaf: Adam's first steps are nearly
    sign(g), so bf16 noise in small gradients moves whole coordinates,
    and ``repro``'s own scan and unrolled compilations of this run drift
    apart leaf by leaf as well (ROADMAP §C)."""
    r_arch, p_arch = r_reg.get_arch(arch), p_reg.get_arch(arch)
    r_cfg, p_cfg = r_arch.reduced, p_arch.reduced
    r_cfg = dataclasses.replace(r_cfg, remat="none")   # faster to compile
    mk = lambda O: O.adamw(O.cosine_schedule(3e-3, 2, 5), weight_decay=1e-4,
                           max_grad_norm=1.0)
    r_tx, p_tx = mk(RO), mk(PO)
    r_state = RTR.init_state(None, lambda _: _repro_params(arch), r_tx)
    p_run = _to_port(r_state)
    r_step = jax.jit(RTR.make_train_step(
        lambda p, b: RT.loss_fn(p, b, r_cfg), r_tx,
        microbatches=microbatches))
    p_step = PTR.make_train_step(lambda p, b: PT.loss_fn(p, b, p_cfg), p_tx,
                                 microbatches=microbatches)
    rng = np.random.default_rng(0)
    shape = r_arch.shape("train_4k")
    r_hist, p_hist = [], []
    for _ in range(5):
        batch = jax.tree_util.tree_map(np.asarray, r_batches.make_batch(
            rng, r_arch, shape, reduced=True))
        p_batch = _to_port(batch)
        p_new, p_m = p_step(_to_port(r_state), p_batch)
        r_new, r_m = r_step(r_state, batch)
        np.testing.assert_allclose(float(p_m["loss"]), float(r_m["loss"]),
                                   rtol=LOSS_RTOL)
        for s, g, w in zip(jax.tree_util.tree_leaves(r_state["params"]),
                           PO.tree_leaves(p_new["params"]),
                           jax.tree_util.tree_leaves(r_new["params"])):
            s = np.asarray(s, np.float64).ravel()
            dg, dw = g.double().numpy().ravel() - s, \
                np.asarray(w, np.float64).ravel() - s
            if not dw.any():          # the schedule's step 0 has lr 0
                assert not dg.any()
                continue
            assert dg @ dw / (np.linalg.norm(dg) * np.linalg.norm(dw)) \
                >= MOVE_COS
        assert int(p_new["step"]) == int(r_new["step"])
        r_state = r_new
        p_run, p_m = p_step(p_run, p_batch)
        r_hist.append(float(r_m["loss"]))
        p_hist.append(float(p_m["loss"]))
    if p_cfg.moe is None:
        np.testing.assert_allclose(p_hist, r_hist, rtol=HISTORY_RTOL)
    assert int(p_run["step"]) == 5


def test_lm_checkpoints_cross_both_ways(tmp_path):
    """A dbrx-smoke train state after one ``adamw`` step: saved by
    ``repro`` and restored by the port, and saved by the port and
    restored by ``repro``, with equal keys and bit-identical arrays."""
    r_cfg = r_reg.get_arch("dbrx-132b").reduced
    tx = RO.adamw(1e-3, weight_decay=1e-4, max_grad_norm=1.0)
    r_state = RTR.init_state(None, lambda _: _repro_params("dbrx-132b"), tx)
    toks = _tokens(r_cfg, shape=(2, 16))
    r_state, _ = jax.jit(RTR.make_train_step(
        lambda p, b: RT.loss_fn(p, b, r_cfg), tx))(
            r_state, {"tokens": toks, "labels": toks})
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(r_state)]

    RCheckpointer(str(tmp_path / "r")).save(r_state, 1, blocking=True)
    p_like = _to_port(r_state)
    got = Checkpointer(str(tmp_path / "r")).restore(p_like, device=CPU)
    leaves = PO.tree_leaves(got)
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        assert a.numpy().dtype == b.dtype and a.numpy().tobytes() == \
            b.tobytes()

    Checkpointer(str(tmp_path / "p")).save(got, 1, blocking=True)
    back = RCheckpointer(str(tmp_path / "p")).restore(r_state)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(r_state))
    for a, b in zip(jax.tree_util.tree_leaves(back), want):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
