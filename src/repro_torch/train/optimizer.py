"""Minimal optax-style optimizer library over trees of tensors.

Counterpart of ``repro.train.optimizer``.  Gradient transformations
compose with :func:`chain`; each is a pair of functions (``init``,
``update``) over nested dicts, lists and tuples of tensors, so a step is
held against ``repro``'s step for step.  ``torch.optim`` is not used: the
autoencoder needs the L1 subgradient and the int8-moment Adam, and both
packages' trainers consume this functional form.  Updates run under
``torch.no_grad()``; every moment is f32 whatever the parameter's dtype.
The transformations a fit steps through (``add_l1_penalty``,
``scale_by_adam``, ``scale_by_schedule``) work on the flattened leaves
with ``torch._foreach_*`` ops, one launch an op for all leaves: a step on
the card is bound by launches, and each op rounds as its one-tensor form.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterable, Iterator, NamedTuple, Optional

import torch

from repro_torch.core.preprocess import as_tensor

Params = Any
OptState = Any
Schedule = Callable[[Any], torch.Tensor]


# ---------------------------------------------------------------------------
# trees: dicts, lists and tuples (named tuples included) of tensors
# ---------------------------------------------------------------------------


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure); anything not a dict/list/tuple is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree_util`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if _is_node(tree):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def _tensor_leaves(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def tree_num_params(tree) -> int:
    """Elements in the tensor leaves of a tree of dicts, lists and tuples."""
    return sum(x.numel() for x in _tensor_leaves(tree))


def tree_size_bytes(tree) -> int:
    """Bytes in the tensor leaves of a tree (meta tensors count too)."""
    return sum(x.numel() * x.element_size() for x in _tensor_leaves(tree))


def _unflatten(t, it):
    if isinstance(t, dict):
        return {k: _unflatten(t[k], it) for k in sorted(t)}
    if _is_node(t):
        out = [_unflatten(c, it) for c in t]
        return type(t)(*out) if hasattr(t, "_fields") else type(t)(out)
    return next(it)


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (in :func:`tree_leaves` order)
    in place of its own.  (A module-level helper, not a recursive closure:
    a closure that calls itself is a reference cycle, which would keep
    ``leaves`` — a step's gradients or updates — alive until the cyclic
    garbage collector ran.)"""
    return _unflatten(tree, iter(leaves))


def params_from_numpy(tree, device: Optional[torch.device] = None):
    """``repro``'s parameter tree (numpy arrays or tensors) → the same tree
    of tensors on ``device``; bytes and layout are kept."""
    return tree_map(lambda v: as_tensor(v, device), tree)


class GradientTransformation(NamedTuple):
    init: Callable[[Params], OptState]
    update: Callable[[Params, OptState, Params], tuple[Params, OptState]]
    # update(grads, state, params) -> (updates, new_state)


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> Params:
    return tree_map(
        lambda p, u: (p + u.to(p.dtype)) if u is not None else p,
        params, updates)


@torch.no_grad()
def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def _f32(step) -> torch.Tensor:
    return as_tensor(step).to(torch.float32)


# ---------------------------------------------------------------------------
# schedules: step (int or tensor) → f32 tensor
# ---------------------------------------------------------------------------


def constant_schedule(value: float) -> Schedule:
    # a fill on the step's device: no host-to-device copy a step
    return lambda step: torch.full((), value, dtype=torch.float32,
                                   device=_f32(step).device)


def cosine_schedule(peak: float, warmup_steps: int, total_steps: int,
                    end_fraction: float = 0.1) -> Schedule:
    def sched(step):
        step = _f32(step)
        warm = peak * step / max(1.0, warmup_steps)
        t = torch.clamp((step - warmup_steps)
                        / max(1.0, total_steps - warmup_steps), 0.0, 1.0)
        cos = peak * (end_fraction + (1 - end_fraction)
                      * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return sched


def linear_warmup_schedule(peak: float, warmup_steps: int) -> Schedule:
    def sched(step):
        step = _f32(step)
        return peak * torch.clamp(step / max(1.0, warmup_steps), max=1.0)
    return sched


def _as_schedule(lr) -> Schedule:
    return lr if callable(lr) else constant_schedule(lr)


# ---------------------------------------------------------------------------
# transformations
# ---------------------------------------------------------------------------


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, state, params=None):
        norm = global_norm(grads)
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
        return tree_map(lambda g: g * scale, grads), state

    return GradientTransformation(init, update)


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: Params
    nu: Params


def _count_like(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def _bias_corrections(b1: float, b2: float, count: torch.Tensor):
    """``1 − b ** count`` in f32, as ``repro`` computes them."""
    c = count.to(torch.float32)
    f32 = lambda b: torch.full((), b, dtype=torch.float32, device=c.device)
    return 1 - f32(b1) ** c, 1 - f32(b2) ** c


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return ScaleByAdamState(count=_count_like(params),
                                mu=tree_map(zeros, params),
                                nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(grads, state, params=None):
        count = state.count + 1
        g = [x.float() for x in tree_leaves(grads)]
        mu = torch._foreach_add(torch._foreach_mul(tree_leaves(state.mu), b1),
                                torch._foreach_mul(g, 1 - b1))
        nu = torch._foreach_add(torch._foreach_mul(tree_leaves(state.nu), b2),
                                torch._foreach_mul(torch._foreach_mul(g, g),
                                                   1 - b2))
        c1, c2 = _bias_corrections(b1, b2, count)
        den = torch._foreach_add(torch._foreach_sqrt(
            torch._foreach_div(nu, c2)), eps)
        updates = torch._foreach_div(torch._foreach_div(mu, c1), den)
        return tree_unflatten(grads, updates), ScaleByAdamState(
            count, tree_unflatten(grads, mu), tree_unflatten(grads, nu))

    return GradientTransformation(init, update)


class ScaleByAdamQ8State(NamedTuple):
    count: torch.Tensor
    mu_q: Params            # int8 codes
    mu_scale: Params        # per-tensor absmax scales
    nu_q: Params
    nu_scale: Params


def _q(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 codes and per-tensor scale; rounds half to even, as jnp does."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-20
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def _dq(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def scale_by_adam_q8(b1: float = 0.9, b2: float = 0.999,
                     eps: float = 1e-8) -> GradientTransformation:
    """Adam with int8-quantized moments (per-tensor absmax scaling): m and
    v are stored as int8 + one f32 scale per tensor, dequantized, updated
    and requantized each step."""

    def init(params):
        z8 = lambda p: torch.zeros(p.shape, dtype=torch.int8, device=p.device)
        zs = lambda p: torch.zeros((), dtype=torch.float32, device=p.device)
        return ScaleByAdamQ8State(
            count=_count_like(params),
            mu_q=tree_map(z8, params), mu_scale=tree_map(zs, params),
            nu_q=tree_map(z8, params), nu_scale=tree_map(zs, params))

    @torch.no_grad()
    def update(grads, state, params=None):
        count = state.count + 1
        mu = tree_map(lambda q, s, g: b1 * _dq(q, s) + (1 - b1) * g.float(),
                      state.mu_q, state.mu_scale, grads)
        nu = tree_map(lambda q, s, g: (b2 * _dq(q, s)
                                       + (1 - b2) * torch.square(g.float())),
                      state.nu_q, state.nu_scale, grads)
        mu_qs, nu_qs = tree_map(_q, mu), tree_map(_q, nu)
        c1, c2 = _bias_corrections(b1, b2, count)
        updates = tree_map(lambda m, v: (m / c1) / (torch.sqrt(v / c2) + eps),
                           mu, nu)
        part = lambda t, i: tree_map(lambda _, qs: qs[i], mu, t)
        return updates, ScaleByAdamQ8State(
            count, part(mu_qs, 0), part(mu_qs, 1),
            part(nu_qs, 0), part(nu_qs, 1))

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float,
                        mask_fn: Optional[Callable] = None,
                        ) -> GradientTransformation:
    """Adds wd·param to the (normalized-gradient) update. mask_fn(p)
    returns True for params to decay; default: decay only ndim >= 2."""

    def init(params):
        return ()

    @torch.no_grad()
    def update(updates, state, params):
        if params is None:
            raise ValueError("add_decayed_weights needs params")

        def f(u, p):
            decay = weight_decay if (mask_fn is None and p.ndim >= 2) else (
                weight_decay if (mask_fn is not None and mask_fn(p)) else 0.0)
            return u + decay * p.float()

        return tree_map(f, updates, params), state

    return GradientTransformation(init, update)


def scale_by_schedule(lr) -> GradientTransformation:
    sched = _as_schedule(lr)

    def init(params):
        return _count_like(params)

    @torch.no_grad()
    def update(updates, count, params=None):
        step_lr = sched(count).to(count.device)
        return tree_unflatten(updates, torch._foreach_mul(
            tree_leaves(updates), -step_lr)), count + 1

    return GradientTransformation(init, update)


def add_l1_penalty(l1: float) -> GradientTransformation:
    """Subgradient of λ·|w|₁ added to grads (paper autoencoder Table 3)."""

    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, state, params):
        signs = torch._foreach_sign([p.float() for p in tree_leaves(params)])
        return tree_unflatten(grads, torch._foreach_add(
            tree_leaves(grads), torch._foreach_mul(signs, l1))), state

    return GradientTransformation(init, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


def minimize(params: Params, loss_fn: Callable, batches: Iterable,
             tx: GradientTransformation) -> Iterator[tuple[Params, Any]]:
    """One step of ``tx`` on ``loss_fn(params, *batch)`` per batch of
    ``batches``, gradients by autograd; yields (params, loss) after each
    step.  The yielded parameters require grad (the next step's leaves):
    detach them to keep them."""
    opt_state = tx.init(params)
    params = tree_map(lambda p: p.detach().requires_grad_(), params)
    for batch in batches:
        loss = loss_fn(params, *batch)
        loss.backward()
        updates, opt_state = tx.update(tree_map(lambda p: p.grad, params),
                                       opt_state, params)
        params = tree_map(lambda p: p.requires_grad_(),
                          apply_updates(params, updates))
        yield params, loss


# ---------------------------------------------------------------------------
# user-facing factories
# ---------------------------------------------------------------------------


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, l1: float = 0.0,
          max_grad_norm: Optional[float] = None,
          quantized_state: bool = False) -> GradientTransformation:
    parts: list[GradientTransformation] = []
    if l1 > 0:
        parts.append(add_l1_penalty(l1))
    if max_grad_norm is not None:
        parts.append(clip_by_global_norm(max_grad_norm))
    parts.append(scale_by_adam_q8(b1, b2, eps) if quantized_state
                 else scale_by_adam(b1, b2, eps))
    if weight_decay > 0:
        parts.append(add_decayed_weights(weight_decay))
    parts.append(scale_by_schedule(lr))
    return chain(*parts)


def sgd(lr, momentum: float = 0.0) -> GradientTransformation:
    if momentum == 0.0:
        return chain(scale_by_schedule(lr))

    def init(params):
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)

    @torch.no_grad()
    def update(grads, state, params=None):
        state = tree_map(lambda m, g: momentum * m + g.float(), state, grads)
        return state, state

    return chain(GradientTransformation(init, update), scale_by_schedule(lr))


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Config-file friendly optimizer spec."""

    name: str = "adamw"
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    max_grad_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"  # constant|cosine|warmup_linear
    quantized_state: bool = False  # int8 Adam moments (see scale_by_adam_q8)

    def build(self) -> GradientTransformation:
        if self.schedule == "cosine":
            lr = cosine_schedule(self.lr, self.warmup_steps, self.total_steps)
        elif self.schedule == "warmup_linear":
            lr = linear_warmup_schedule(self.lr, self.warmup_steps)
        else:
            lr = constant_schedule(self.lr)
        if self.name == "adamw":
            return adamw(lr, self.b1, self.b2, self.eps, self.weight_decay,
                         max_grad_norm=self.max_grad_norm,
                         quantized_state=self.quantized_state)
        if self.name == "sgd":
            return sgd(lr)
        raise ValueError(f"unknown optimizer {self.name!r}")
