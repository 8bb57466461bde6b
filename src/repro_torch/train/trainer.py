"""Train-step factory: loss → grads (autograd) → optimizer, with microbatch
gradient accumulation and global-norm metrics.

Counterpart of ``repro.train.trainer``.  State layout (a plain tree):
    {"params": …, "opt": tx_state, "step": int32 tensor}

The step is a plain function of (state, batch) that returns a new state;
it never waits for the device, so a loop reads values on the host only
where it logs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.preprocess import as_tensor
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.optimizer import (tree_leaves, tree_map,
                                         tree_unflatten)
from repro_torch.utils import DeviceLike, resolve_device

#: ``repro``'s optimizer-state named tuples → the port's, by class name
_STATE_TYPES = {c.__name__: c for c in (opt_lib.ScaleByAdamState,
                                        opt_lib.ScaleByAdamQ8State)}


def _leaf_device(tree: Any) -> Optional[torch.device]:
    leaves = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
    return leaves[0].device if leaves else None


def init_state(generator: Optional[torch.Generator],
               init_params_fn: Callable, tx: opt_lib.GradientTransformation
               ) -> dict:
    params = init_params_fn(generator)
    return {"params": params, "opt": tx.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_leaf_device(params))}


def abstract_state(abstract_params: Any,
                   tx: opt_lib.GradientTransformation) -> dict:
    """Meta-tensor state tree (shapes and dtypes, no storage)."""
    return {"params": abstract_params, "opt": tx.init(abstract_params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def state_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """``repro``'s parameters or train state (numpy arrays, or anything
    ``np.array`` reads) → the port's tree of tensors on ``device``; bytes,
    layout and structure are kept, and ``repro``'s optimizer-state named
    tuples become the port's."""
    return _from_numpy(tree, resolve_device(device))


def _from_numpy(t: Any, dev: torch.device) -> Any:
    if isinstance(t, dict):
        return {k: _from_numpy(v, dev) for k, v in t.items()}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        cls = _STATE_TYPES.get(type(t).__name__, type(t))
        return cls(*(_from_numpy(v, dev) for v in t))
    if isinstance(t, (list, tuple)):
        return type(t)(_from_numpy(v, dev) for v in t)
    return as_tensor(np.asarray(t), dev)


def _split_microbatches(batch: Any, n: int) -> Any:
    def f(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by microbatches {n}")
        return x.reshape(n, b // n, *x.shape[1:])
    return tree_map(f, batch)


def make_train_step(loss_fn: Callable[[Any, Any], tuple[torch.Tensor, dict]],
                    tx: opt_lib.GradientTransformation,
                    microbatches: int = 1,
                    grad_transform: Optional[Callable] = None) -> Callable:
    """Build ``train_step(state, batch) → (state, metrics)``.

    ``loss_fn(params, batch) → (loss, metrics_dict)``.
    ``grad_transform`` optionally post-processes grads.  With
    ``microbatches > 1`` the f32 gradients of the microbatches are
    accumulated in one Python loop (``repro``'s scan and its unrolled form
    give the same sums, so the port has no ``unroll_microbatches``), and
    the metrics are the last microbatch's.
    """

    def compute_grads(params, batch):
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
            loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten(params, grads)

    def train_step(state: dict, batch: Any) -> tuple[dict, dict]:
        params = state["params"]
        if microbatches > 1:
            mb = _split_microbatches(batch, microbatches)
            loss = None
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(microbatches):
                micro = tree_map(lambda x, i=i: x[i], mb)
                li, metrics, gi = compute_grads(params, micro)
                loss = li if loss is None else loss + li
                grads = tree_map(lambda a, g: a + g.float(), grads, gi)
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
        else:
            loss, metrics, grads = compute_grads(params, batch)

        if grad_transform is not None:
            grads = grad_transform(grads)

        updates, opt = tx.update(grads, state["opt"], params)
        new_state = {"params": opt_lib.apply_updates(params, updates),
                     "opt": opt, "step": state["step"] + 1}
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = opt_lib.global_norm(grads)
        return new_state, metrics

    return train_step


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 0           # 0 = disabled; the Checkpointer
                                        # passed in holds dir and retention


def run_train_loop(train_step, state, batch_iter, cfg: TrainLoopConfig,
                   checkpointer=None, preemption=None,
                   log_fn=print) -> tuple[dict, list[dict]]:
    """Host training loop with checkpointing + preemption handling.

    ``batch_iter`` yields batches; ``checkpointer`` is a
    :class:`repro_torch.train.checkpoint.Checkpointer`; ``preemption`` a
    :class:`repro_torch.train.fault_tolerance.PreemptionHandler`.  The host
    reads the device once at the start (the step) and on log steps.
    """
    history = []
    start = int(state["step"])
    for step in range(start, cfg.total_steps):
        batch = next(batch_iter)
        state, metrics = train_step(state, batch)
        if preemption is not None and preemption.should_stop():
            if checkpointer is not None:
                checkpointer.save(state, step + 1, blocking=True)
            log_fn(f"[preempt] saved emergency checkpoint at step {step+1}")
            break
        if cfg.log_every and (step + 1) % cfg.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step + 1, **m})
            log_fn(f"step {step+1}: " +
                   " ".join(f"{k}={v:.4f}" for k, v in m.items()))
        if (cfg.checkpoint_every and checkpointer is not None
                and (step + 1) % cfg.checkpoint_every == 0):
            checkpointer.save(state, step + 1)
    return state, history
