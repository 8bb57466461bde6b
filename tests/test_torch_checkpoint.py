"""``repro_torch.train.checkpoint`` and ``fault_tolerance`` against
``repro``'s.

Checkpoints cross between the packages both ways: a train state that
``repro``'s ``Checkpointer`` saves restores in the port, and the port's in
``repro``, with equal keys (``repro``'s ``tree_flatten_with_path`` names)
and bit-identical arrays, for ``adamw`` with weight decay and clipping
and for the int8-moment Adam.  Then ``repro``'s ``tests/test_checkpoint.py``
replayed on the port, plus the snapshot taken before an async write, an
async write's error raised by ``wait()``, a restore onto meta tensors, and
a real SIGTERM stopping the loop.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.train import optimizer as RO  # noqa: E402
from repro.train import trainer as RT  # noqa: E402
from repro.train.checkpoint import Checkpointer as RCheckpointer  # noqa: E402
from repro_torch.train import optimizer as PO  # noqa: E402
from repro_torch.train import trainer as PT  # noqa: E402
from repro_torch.train.checkpoint import Checkpointer  # noqa: E402
from repro_torch.train.fault_tolerance import (  # noqa: E402
    PreemptionHandler, StragglerMonitor, with_retries)

CPU = "cpu"
PARAMS = {"w": np.arange(6, dtype=np.float32).reshape(2, 3) / 7,
          "l": [{"b": np.linspace(-1, 1, 3).astype(np.float32)}]}
TXS = {"adamw": (lambda O: O.adamw(1e-2, weight_decay=1e-4,
                                   max_grad_norm=1.0)),
       "adamw_q8": (lambda O: O.adamw(1e-2, quantized_state=True))}
ADAMW_KEYS = {"params/w", "params/l/0/b", "opt/1/.count", "opt/1/.mu/w",
              "opt/1/.mu/l/0/b", "opt/1/.nu/w", "opt/1/.nu/l/0/b", "opt/3",
              "step"}


def _trained_states(tx_name, steps=3):
    """repro's and the port's train states after the same steps."""
    r_tx, p_tx = TXS[tx_name](RO), TXS[tx_name](PO)
    r_state = RT.init_state(None, lambda _: jax.tree_util.tree_map(
        jnp.asarray, PARAMS), r_tx)
    loss = lambda p, xp: (xp.sum(xp.square(p["w"])) + xp.sum(p["l"][0]["b"]),
                          {})
    r_step = jax.jit(RT.make_train_step(lambda p, b: loss(p, jnp), r_tx))
    for _ in range(steps):
        r_state, _ = r_step(r_state, {})
    p_state = PT.init_state(None, lambda _: PO.params_from_numpy(
        PARAMS, torch.device(CPU)), p_tx)
    return r_state, p_state


def _keys(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)["keys"]


@pytest.mark.parametrize("tx_name", sorted(TXS))
def test_repro_checkpoint_restores_in_the_port(tmp_path, tx_name):
    r_state, p_like = _trained_states(tx_name)
    RCheckpointer(str(tmp_path)).save(r_state, 3, blocking=True)
    got = Checkpointer(str(tmp_path)).restore(p_like, device=CPU)
    assert type(got["opt"]) is tuple
    assert [type(s) for s in got["opt"]] == [type(s) for s in p_like["opt"]]
    want = jax.tree_util.tree_leaves(r_state)
    leaves = PO.tree_leaves(got)
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and a.numpy().tobytes() == \
            b.tobytes()
    if tx_name == "adamw":
        assert set(_keys(tmp_path, 3)) == ADAMW_KEYS


@pytest.mark.parametrize("tx_name", sorted(TXS))
def test_port_checkpoint_restores_in_repro(tmp_path, tx_name):
    r_like, _ = _trained_states(tx_name, steps=0)
    r_trained, _ = _trained_states(tx_name)
    p_state = PT.state_from_numpy(
        jax.tree_util.tree_map(np.asarray, r_trained), CPU)
    Checkpointer(str(tmp_path / "p")).save(p_state, 3, blocking=True)
    RCheckpointer(str(tmp_path / "r")).save(r_trained, 3, blocking=True)
    assert _keys(tmp_path / "p", 3) == _keys(tmp_path / "r", 3)
    got = RCheckpointer(str(tmp_path / "p")).restore(r_like)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(r_trained))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(r_trained)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_port_keys_name_repro_paths():
    r_state, p_state = _trained_states("adamw", steps=0)
    from repro.train.checkpoint import _flatten as r_flatten
    from repro_torch.train.checkpoint import _flatten as p_flatten
    assert list(p_flatten(p_state)) == list(r_flatten(r_state))
    assert set(p_flatten(p_state)) == ADAMW_KEYS


# ---------------------------------------------------------------------------
# repro's tests/test_checkpoint.py, replayed on the port
# ---------------------------------------------------------------------------


def _state():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "b": torch.ones(3)},
            "opt": (torch.zeros(()),),
            "step": torch.tensor(5, dtype=torch.int32)}


def _assert_trees_equal(a, b):
    la, lb = PO.tree_leaves(a), PO.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = _state()
    ck.save(state, 5, blocking=True)
    _assert_trees_equal(ck.restore(state, device=CPU), state)


def test_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(_state(), 1, blocking=False)
    ck.wait()
    assert ck.latest_step() == 1


def test_async_save_snapshots_before_returning(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = _state()
    ck.save(state, 1, blocking=False)
    state["params"]["w"].add_(100.0)            # a later in-place write
    ck.wait()
    _assert_trees_equal(ck.restore(_state(), device=CPU), _state())


def test_async_write_error_is_raised_by_wait(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"))
    os.rmdir(tmp_path / "ck")                   # the write cannot stage
    (tmp_path / "ck").write_text("not a directory")
    ck.save(_state(), 1, blocking=False)
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                                   # raised once


def test_latest_and_retention(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(_state(), s, blocking=True)
    assert ck.latest_step() == 4
    assert ck.all_steps() == [3, 4]


def test_no_partial_checkpoints_visible(tmp_path):
    ck = Checkpointer(str(tmp_path))
    os.makedirs(tmp_path / ".tmp-step_00000009")
    assert ck.all_steps() == []
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore(_state(), device=CPU)


def test_restore_missing_key_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(_state(), 1, blocking=True)
    bigger = dict(_state())
    bigger["extra"] = torch.zeros(2)
    with pytest.raises(KeyError):
        ck.restore(bigger, device=CPU)


def test_stale_latest_recovers(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(_state(), 3, blocking=True)
    with open(tmp_path / "LATEST", "w") as f:
        f.write("99")
    assert ck.latest_step() == 3


def test_restore_onto_meta_state(tmp_path):
    tx = PO.adamw(1e-3, weight_decay=1e-4, max_grad_norm=1.0)
    state = PT.init_state(None, lambda _: PO.params_from_numpy(
        PARAMS, torch.device(CPU)), tx)
    ck = Checkpointer(str(tmp_path))
    ck.save(state, 2, blocking=True)
    like = PT.abstract_state(PO.tree_map(
        lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"),
        state["params"]), tx)
    _assert_trees_equal(ck.restore(like, device=CPU), state)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ck.restore(like)                    # the default device is cuda


def test_resume_training_loop(tmp_path):
    """Kill training mid-run; resume reproduces the uninterrupted run."""
    tx = PO.sgd(0.1)
    step = PT.make_train_step(
        lambda p, b: (torch.sum(torch.square(p["w"] - 4.0)), {}), tx)

    def fresh():
        return {"params": {"w": torch.zeros(2)},
                "opt": tx.init({"w": torch.zeros(2)}),
                "step": torch.zeros((), dtype=torch.int32)}

    s = fresh()
    for _ in range(10):
        s, _ = step(s, {})
    want = s["params"]["w"]
    ck = Checkpointer(str(tmp_path))
    s = fresh()
    for _ in range(6):
        s, _ = step(s, {})
    ck.save(s, 6, blocking=True)
    restored = ck.restore(fresh(), device=CPU)
    assert int(restored["step"]) == 6
    for _ in range(4):
        restored, _ = step(restored, {})
    assert torch.equal(restored["params"]["w"], want)


def _preemption_run(tmp_path, handler, trigger):
    tx = PO.sgd(0.1)
    state = PT.init_state(None, lambda _: {"w": torch.ones(2)}, tx)
    step = PT.make_train_step(lambda p, b: (torch.sum(p["w"]), {}), tx)
    ck = Checkpointer(str(tmp_path))

    def batches():
        trigger()
        while True:
            yield {}

    cfg = PT.TrainLoopConfig(total_steps=50, log_every=0)
    state, _ = PT.run_train_loop(step, state, batches(), cfg,
                                 checkpointer=ck, preemption=handler,
                                 log_fn=lambda *_: None)
    return state, ck


def test_preemption_handler_stops_loop(tmp_path):
    handler = PreemptionHandler(signals=())
    state, ck = _preemption_run(tmp_path, handler, handler.trigger)
    assert int(state["step"]) == 1
    assert ck.latest_step() == 1


def test_sigterm_stops_loop_with_an_emergency_checkpoint(tmp_path):
    handler = PreemptionHandler()
    try:
        state, ck = _preemption_run(
            tmp_path, handler, lambda: os.kill(os.getpid(), signal.SIGTERM))
    finally:
        handler.uninstall()
    assert handler.should_stop()
    assert int(state["step"]) == 1 and ck.latest_step() == 1
    _assert_trees_equal(ck.restore(state, device=CPU), state)


def test_straggler_monitor():
    mon = StragglerMonitor(threshold=2.0, warmup_steps=2)
    for _ in range(5):
        assert not mon.observe(0.1)
    assert mon.observe(0.5)
    assert mon.flagged


def test_with_retries():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise IOError("transient")
        return "ok"

    assert with_retries(flaky, retries=3, backoff=0.0,
                        log_fn=lambda *_: None) == "ok"
    assert len(calls) == 3

    def hard_fail():
        raise ValueError("logic error")

    with pytest.raises(ValueError):
        with_retries(hard_fail, retries=2, backoff=0.0,
                     log_fn=lambda *_: None)
