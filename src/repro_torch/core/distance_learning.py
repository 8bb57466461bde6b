"""Distance-preserving and contrastive dimension reduction (paper §5.4).

Counterpart of ``repro.core.distance_learning``: the paper's negative
results, for completeness and ablation.

* **Similarity learning** — fit f minimizing
  ``MSE(sim(f(tᵢ), f(tⱼ)), sim(tᵢ, tⱼ))`` over sampled pairs, where f is a
  linear projection (or a one-hidden-layer MLP).
* **Contrastive learning** — InfoNCE with each point's nearest neighbour
  in the original space as its positive and the batch as negatives.

Pair and batch indices are drawn with ``torch.randint`` on a generator on
the data's device (no host sync a step), and the initial weights with the
``torch.Generator`` given to ``fit``: a fit is held to ``repro``'s by
quality.  Each step loop takes its index stream as an argument, so a test
can feed it ``repro``'s and reach ``repro``'s fitted parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.core.preprocess import Transform
from repro_torch.train import optimizer as opt_lib


@dataclasses.dataclass(frozen=True)
class DistanceLearnerConfig:
    dim: int = 128
    sim: str = "ip"           # ip | l2
    lr: float = 1e-3
    batch_size: int = 256
    steps: int = 2000
    hidden: int = 0           # 0 → linear projection; else 1 hidden layer
    seed: int = 0


def _generator(rng: Optional[torch.Generator], seed: int) -> torch.Generator:
    return rng if rng is not None else torch.Generator().manual_seed(seed)


def _device_generator(rng: torch.Generator,
                      device: torch.device) -> torch.Generator:
    """A generator on ``device`` for the index draws: ``rng`` itself when it
    lies there, else one seeded from a draw of ``rng``."""
    if rng.device == torch.device(device):
        return rng
    seed = int(torch.randint(0, 2**62, (1,), generator=rng,
                             device=rng.device))
    return torch.Generator(device=device).manual_seed(seed)


def _randn(rng: torch.Generator, shape, device, fan_in: int) -> torch.Tensor:
    return (torch.randn(shape, generator=rng, device=rng.device)
            / float(np.sqrt(fan_in))).to(device)


def _step_loop(params: dict, loss_fn, batches: Iterable, lr: float) -> dict:
    """Adam(W) steps of ``loss_fn(params, *batch)`` over ``batches``."""
    for params, _ in opt_lib.minimize(params, loss_fn, batches,
                                      opt_lib.adamw(lr)):
        pass
    return opt_lib.tree_map(lambda p: p.detach(), params)


class SimilarityPreservingProjection(Transform):
    """Learn f with MSE(sim(f(x), f(y)), sim(x, y)) on random pairs."""

    name = "distance_learning"

    state_keys = ("w1", "b1")

    def __init__(self, config: DistanceLearnerConfig | None = None, **kw):
        super().__init__()
        self.config = config or DistanceLearnerConfig(**kw)
        self.params = None

    def init_config(self):
        return dataclasses.asdict(self.config)

    def load_state(self, sd, device=None):
        super().load_state(sd, device)
        self.params = dict(self.state) if self.fitted else None
        return self

    def _apply(self, params, x):
        if "w2" in params:
            h = torch.tanh(x @ params["w1"] + params["b1"])
            return h @ params["w2"] + params["b2"]
        return x @ params["w1"] + params["b1"]

    def _sim(self, a, b):
        if self.config.sim == "ip":
            return a @ b.T
        d2 = (torch.sum(a * a, -1)[:, None] + torch.sum(b * b, -1)[None, :]
              - 2 * (a @ b.T))
        return -d2

    def _loss(self, params, xa, xb):
        target = self._sim(xa, xb)
        pred = self._sim(self._apply(params, xa), self._apply(params, xb))
        return torch.mean(torch.square(pred - target))

    def init_params(self, rng: torch.Generator, d_in: int,
                    device: torch.device) -> dict:
        cfg = self.config
        if cfg.hidden:
            return {"w1": _randn(rng, (d_in, cfg.hidden), device, d_in),
                    "b1": torch.zeros((cfg.hidden,), device=device),
                    "w2": _randn(rng, (cfg.hidden, cfg.dim), device,
                                 cfg.hidden),
                    "b2": torch.zeros((cfg.dim,), device=device)}
        return {"w1": _randn(rng, (d_in, cfg.dim), device, d_in),
                "b1": torch.zeros((cfg.dim,), device=device)}

    def _train(self, params: dict, x: torch.Tensor,
               pairs: Iterable[tuple[torch.Tensor, torch.Tensor]]) -> dict:
        """One step per (ia, ib) pair of index tensors."""
        return _step_loop(params, self._loss,
                          ((x[ia], x[ib]) for ia, ib in pairs),
                          self.config.lr)

    def fit(self, docs, queries=None, rng=None):
        cfg = self.config
        x = docs.float()
        rng = _generator(rng, cfg.seed)
        params = self.init_params(rng, x.shape[-1], x.device)
        g = _device_generator(rng, x.device)
        draw = lambda: torch.randint(0, x.shape[0], (cfg.batch_size,),
                                     generator=g, device=x.device)
        params = self._train(params, x,
                             ((draw(), draw()) for _ in range(cfg.steps)))
        self.params = params
        self.state.update(params)
        self.fitted = True
        return self

    def __call__(self, x, kind="docs"):
        return self._apply(self.params, x)

    def output_dim(self, input_dim):
        return self.config.dim


class ContrastiveProjection(Transform):
    """InfoNCE over original-space nearest neighbours (paper §5.4, ¶2)."""

    name = "contrastive"
    state_keys = ("w",)

    def __init__(self, dim: int = 128, lr: float = 1e-3, steps: int = 1000,
                 batch_size: int = 128, n_neighbors: int = 4,
                 temperature: float = 0.1, seed: int = 0):
        super().__init__()
        self.dim, self.lr, self.steps = dim, lr, steps
        self.batch_size, self.n_neighbors = batch_size, n_neighbors
        self.temperature, self.seed = temperature, seed
        self.params = None

    def init_config(self):
        return {"dim": self.dim, "lr": self.lr, "steps": self.steps,
                "batch_size": self.batch_size,
                "n_neighbors": self.n_neighbors,
                "temperature": self.temperature, "seed": self.seed}

    def load_state(self, sd, device=None):
        super().load_state(sd, device)
        self.params = {"w": self.state["w"]} if self.fitted else None
        return self

    def _loss(self, params, anchors, pos):
        za = anchors @ params["w"]
        zp = pos @ params["w"]
        za = za / (torch.linalg.vector_norm(za, dim=-1, keepdim=True) + 1e-9)
        zp = zp / (torch.linalg.vector_norm(zp, dim=-1, keepdim=True) + 1e-9)
        logits = za @ zp.T / self.temperature
        return -torch.mean(torch.diagonal(torch.log_softmax(logits, dim=-1)))

    @staticmethod
    def positives(xs: torch.Tensor) -> torch.Tensor:
        """Each row's nearest neighbour by inner product, itself excluded
        (first occurrence among ties): O(sub²) on the fit subsample."""
        sims = xs @ xs.T
        sims.diagonal().sub_(1e9)          # repro: sims − 1e9·I, in place
        return torch.argmax(sims, dim=1)

    def _train(self, params: dict, xs: torch.Tensor, positives: torch.Tensor,
               batches: Iterable[torch.Tensor]) -> dict:
        """One step per tensor of anchor indices into ``xs``."""
        return _step_loop(params, self._loss,
                          ((xs[idx], xs[positives[idx]]) for idx in batches),
                          self.lr)

    def fit(self, docs, queries=None, rng=None):
        x = docs.float()
        n, d_in = x.shape
        rng = _generator(rng, self.seed)
        params = {"w": _randn(rng, (d_in, self.dim), x.device, d_in)}
        sub = min(n, 20000)
        xs = x[:sub]
        pos = self.positives(xs)
        g = _device_generator(rng, x.device)
        batches = (torch.randint(0, sub, (self.batch_size,), generator=g,
                                 device=x.device) for _ in range(self.steps))
        self.params = self._train(params, xs, pos, batches)
        self.state["w"] = self.params["w"]
        self.fitted = True
        return self

    def __call__(self, x, kind="docs"):
        return x @ self.params["w"]

    def output_dim(self, input_dim):
        return self.dim
