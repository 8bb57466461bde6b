"""Autoencoder index compression (paper §4.3).

Counterpart of ``repro.core.autoencoder``.  Three bottleneck
architectures from the paper (768 → 128 default):

1. ``linear``          — e₁ = L(768→128),                    r₁ = L(128→768)
2. ``full``            — e₂ = L→tanh→L→tanh→L (768,512,256,128), r₂ = mirror
3. ``shallow_decoder`` — e₃ = e₂,                            r₃ = L(128→768)

plus optional L1 regularization on all weights (Table 3: batch 128, Adam,
lr 1e-3, λ_L1 = 10^-5.9).  Loss is MSE reconstruction; only the encoder
is applied at compression time.

Parameters are ``repro``'s tree, ``{"enc": [{"w", "b"}, …], "dec": […]}``
with ``w`` laid out (d_in, d_out), so state and artifacts carry across
unchanged.  Gradients come from ``torch.autograd``; the step is
:mod:`repro_torch.train.optimizer`'s ``adamw``.  The fit set stays on its
device, and each epoch's shuffle (numpy ``default_rng(seed)``, the same
permutations as ``repro``'s) is copied there once.  The initial weights
are drawn from a ``torch.Generator``, so a fit is held to ``repro``'s by
quality; started from ``repro``'s initial parameters it reaches
``repro``'s fitted ones.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.preprocess import Transform
from repro_torch.train import optimizer as opt_lib

# Paper Table 3 hyperparameters.
PAPER_BATCH_SIZE = 128
PAPER_LR = 1e-3
PAPER_L1 = 10 ** -5.9


def _init_linear(rng: torch.Generator, d_in: int, d_out: int) -> dict:
    # Glorot-uniform, zero bias (as repro)
    limit = float(np.sqrt(6.0 / (d_in + d_out)))
    u = torch.rand((d_in, d_out), generator=rng, device=rng.device)
    return {"w": u * (2 * limit) - limit,
            "b": torch.zeros((d_out,), device=rng.device)}


def _apply_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def _mlp_dims(variant: str, d_in: int, d_bottleneck: int) -> list[int]:
    if variant == "linear":
        return [d_in, d_bottleneck]
    # full / shallow_decoder encoder: d → 512 → 256 → bottleneck (paper dims
    # scale if d_in != 768: geometric interpolation, repro's arithmetic)
    if d_in == 768:
        return [768, 512, 256, d_bottleneck]
    mid1 = int(2 ** round(np.log2(np.sqrt(d_in * np.sqrt(d_in * d_bottleneck)))))
    mid2 = int(2 ** round(np.log2(np.sqrt(mid1 * d_bottleneck))))
    return [d_in, max(mid1, d_bottleneck), max(mid2, d_bottleneck),
            d_bottleneck]


def init_autoencoder(rng: torch.Generator, variant: str, d_in: int,
                     d_bottleneck: int,
                     device: Optional[torch.device] = None) -> dict:
    """Initial parameters, drawn on ``rng``'s device, placed on ``device``
    (default: the generator's)."""
    enc_dims = _mlp_dims(variant, d_in, d_bottleneck)
    if variant in ("linear", "shallow_decoder"):
        dec_dims = [d_bottleneck, d_in]
    elif variant == "full":
        dec_dims = enc_dims[::-1]
    else:
        raise ValueError(f"unknown autoencoder variant {variant!r}")
    enc = [_init_linear(rng, enc_dims[i], enc_dims[i + 1])
           for i in range(len(enc_dims) - 1)]
    dec = [_init_linear(rng, dec_dims[i], dec_dims[i + 1])
           for i in range(len(dec_dims) - 1)]
    return opt_lib.params_from_numpy({"enc": enc, "dec": dec}, device)


def _mlp(layers: list, h: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(layers):
        h = _apply_linear(layer, h)
        if i < len(layers) - 1:
            h = torch.tanh(h)
    return h


def encode(params: dict, x: torch.Tensor) -> torch.Tensor:
    return _mlp(params["enc"], x)


def decode(params: dict, z: torch.Tensor) -> torch.Tensor:
    return _mlp(params["dec"], z)


def reconstruction_loss(params: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(decode(params, encode(params, x)) - x))


@dataclasses.dataclass(frozen=True)
class AutoencoderConfig:
    variant: str = "shallow_decoder"   # linear | full | shallow_decoder
    bottleneck: int = 128
    l1: float = 0.0                    # PAPER_L1 to enable
    lr: float = PAPER_LR
    batch_size: int = PAPER_BATCH_SIZE
    epochs: int = 5
    fit_on: str = "docs"               # docs | queries | both
    seed: int = 0


def _train(params: dict, x: torch.Tensor, cfg: AutoencoderConfig
           ) -> tuple[dict, list[float]]:
    """``cfg.epochs`` epochs of Adam(W) steps from ``params`` over ``x``;
    the fitted parameters and each epoch's last-step loss.  The tail that
    does not fill a batch is dropped, as ``repro`` drops it."""
    n = x.shape[0]
    bs = min(cfg.batch_size, n)
    steps_per_epoch = max(1, n // bs)
    shuffle_rng = np.random.default_rng(cfg.seed)

    def batches():
        for _ in range(cfg.epochs):
            perm = torch.from_numpy(shuffle_rng.permutation(n)).to(x.device)
            for s in range(steps_per_epoch):
                yield (x[perm[s * bs:(s + 1) * bs]],)

    history = []
    for i, (params, loss) in enumerate(opt_lib.minimize(
            params, reconstruction_loss, batches(),
            opt_lib.adamw(cfg.lr, l1=cfg.l1))):
        if (i + 1) % steps_per_epoch == 0:
            history.append(float(loss.detach()))
    return opt_lib.tree_map(lambda p: p.detach(), params), history


class Autoencoder(Transform):
    """Trainable autoencoder transform (paper §4.3)."""

    name = "autoencoder"

    def __init__(self, config: AutoencoderConfig | None = None, **kw):
        super().__init__()
        self.config = config or AutoencoderConfig(**kw)
        self.params: Optional[dict] = None
        self.loss_history: list[float] = []

    def init_config(self):
        return dataclasses.asdict(self.config)

    # -- fitting ------------------------------------------------------------
    def _fit_set(self, docs, queries):
        cfg = self.config
        if cfg.fit_on == "docs" or queries is None:
            return docs
        if cfg.fit_on == "queries":
            return queries
        return torch.cat([docs, queries], dim=0)

    def fit(self, docs, queries=None, rng=None):
        cfg = self.config
        x = self._fit_set(docs, queries).float()
        if rng is None:
            rng = torch.Generator().manual_seed(cfg.seed)
        params = init_autoencoder(rng, cfg.variant, x.shape[-1],
                                  cfg.bottleneck, device=x.device)
        self.params, history = _train(params, x, cfg)
        self.loss_history.extend(history)
        # flatten into .state for serialization, under repro's keys
        for part in ("enc", "dec"):
            for i, layer in enumerate(self.params[part]):
                self.state[f"{part}{i}_w"] = layer["w"]
                self.state[f"{part}{i}_b"] = layer["b"]
        self.fitted = True
        return self

    def load_state(self, sd, device=None):
        super().load_state(sd, device)
        params = {part: [{"w": self.state[f"{part}{i}_w"],
                          "b": self.state[f"{part}{i}_b"]}
                         for i in range(_n_layers(self.state, part))]
                  for part in ("enc", "dec")}
        if self.fitted and not params["enc"]:
            # the layer count varies with the variant, so the static
            # state_keys check can't cover it: a fitted AE has ≥ 1 encoder
            # layer
            raise ValueError("Autoencoder.load_state: fitted state has no "
                             f"enc0_w/enc0_b layers (keys: "
                             f"{sorted(self.state)})")
        self.params = params
        return self

    # -- application ----------------------------------------------------------
    def __call__(self, x, kind="docs"):
        if self.params is None:
            raise RuntimeError("Autoencoder not fitted")
        return encode(self.params, x)

    def inverse(self, z):
        return decode(self.params, z)

    def output_dim(self, input_dim):
        return self.config.bottleneck


def _n_layers(state: dict, part: str) -> int:
    i = 0
    while f"{part}{i}_w" in state:
        i += 1
    return i
