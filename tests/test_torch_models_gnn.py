"""``repro_torch.models.gnn`` (SchNet) against ``repro.models.gnn``.

From ``repro``'s parameters on batches from ``make_batch`` (byte-equal in
both packages): the graph task on the reduced ``molecule`` shape and the
node task on the reduced ``full_graph_sm`` and ``minibatch_lg`` shapes (as
``repro.launch.steps`` configures them: node features, 64 classes), with
part of the edges masked.  Bars (ROADMAP §C): per-node outputs and node
embeddings (bf16) compared in f32 at rtol 1.6e-2 and atol 1.6e-2 ·
max|value| — the residual adds and bias adds run in bf16 and cancel, so
one bf16 step of an operand near the largest value shows as an absolute
error on a small result; a graph's energy, a sum of bf16 node outputs,
at rtol 1.6e-2 and atol 1.6e-2 · Σ|node output| over its nodes, and the
graph task's MSE within 1e-2 relative (the node task's loss within 1e-3);
each gradient leaf at cosine ≥ 0.999; ``rbf_expand`` and ``ssp`` (f32)
at rtol 1e-5.  Then ``repro``'s own tests replayed on the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs import registry as r_reg  # noqa: E402
from repro.configs.base import SchNetConfig as RSchNetConfig  # noqa: E402
from repro.data import batches as r_batches  # noqa: E402
from repro.models import gnn as RG  # noqa: E402
from repro_torch.configs import registry as p_reg  # noqa: E402
from repro_torch.configs.base import SchNetConfig  # noqa: E402
from repro_torch.models import gnn as PG  # noqa: E402
from repro_torch.train.optimizer import (tree_leaves,  # noqa: E402
                                         tree_unflatten)
from repro_torch.train.trainer import state_from_numpy  # noqa: E402

CPU = "cpu"
F32_RTOL = 1e-5
BF16_TOL = 1.6e-2
LOSS_RTOL = 1e-3
#: the graph task's MSE over energies that are sums of bf16 node outputs
GRAPH_LOSS_RTOL = 1e-2
GRAD_COS = 0.999

CFG = SchNetConfig(n_interactions=2, d_hidden=16, n_rbf=12, n_atom_types=10)
R_CFG = RSchNetConfig(n_interactions=2, d_hidden=16, n_rbf=12,
                      n_atom_types=10)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _to_port(tree):
    return state_from_numpy(jax.tree_util.tree_map(np.asarray, tree), CPU)


def _setup(shape_name, seed=0, mask_edges=True):
    """The reduced schnet config as ``repro.launch.steps`` sets it for the
    shape, repro's params (both packages) and one batch with every fourth
    edge masked."""
    r_arch, p_arch = r_reg.get_arch("schnet"), p_reg.get_arch("schnet")
    shape = r_arch.shape(shape_name)
    dims = r_batches.shape_dims(shape, True)
    if shape.kind in ("gnn_full", "gnn_mini"):
        kw = dict(d_feat_in=dims.get("d_feat", 602), task="node",
                  n_classes=64)
    else:
        kw = dict(d_feat_in=0, task="graph")
    r_cfg = dataclasses.replace(r_arch.reduced, **kw)
    p_cfg = dataclasses.replace(p_arch.reduced, **kw)
    r_params = RG.init(jax.random.PRNGKey(seed), r_cfg)
    batch = r_batches.make_batch(np.random.default_rng(seed), r_arch, shape,
                                 reduced=True)
    batch = jax.tree_util.tree_map(np.asarray, batch)
    if mask_edges:
        batch["edge_mask"] = batch["edge_mask"].copy()
        batch["edge_mask"][::4] = 0.0
    return (r_cfg, p_cfg, r_params, _to_port(r_params),
            jax.tree_util.tree_map(jnp.asarray, batch), _to_port(batch))


def _port_grads(loss_fn, params):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, _ = loss_fn(tree_unflatten(params, leaves))
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, grads)


def _assert_grads_close(got, want):
    got = [x.double().numpy().ravel() for x in tree_leaves(got)]
    want = [np.asarray(x, np.float64).ravel()
            for x in jax.tree_util.tree_leaves(want)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
        assert cos >= GRAD_COS, cos


SHAPES = ["molecule", "full_graph_sm", "minibatch_lg"]


def _assert_bf16_close(got, want):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=BF16_TOL,
                               atol=BF16_TOL * np.abs(want).max())


def _per_node(batch, n, torch_ids):
    """The batch with every node its own graph: forward's graph task then
    returns the per-node outputs."""
    ids = np.arange(n, dtype=np.int32)
    return dict(batch, graph_ids=torch.from_numpy(ids) if torch_ids
                else jnp.asarray(ids))


@pytest.mark.parametrize("shape_name", SHAPES)
def test_forward_loss_and_grads_match_repro(shape_name):
    r_cfg, p_cfg, r_params, p_params, r_batch, p_batch = _setup(shape_name)
    r_fwd = jax.jit(lambda p, b, n: RG.forward(p, b, r_cfg, n_graphs=n),
                    static_argnums=2)
    want_out = r_fwd(r_params, r_batch, None)
    got_out = PG.forward(p_params, p_batch, p_cfg)
    assert tuple(got_out.shape) == want_out.shape
    assert got_out.dtype == torch.float32
    if r_cfg.task == "graph":
        n = int(r_batch["positions"].shape[0])
        node_want = r_fwd(r_params, _per_node(r_batch, n, False), n)
        node_got = PG.forward(p_params, _per_node(p_batch, n, True), p_cfg,
                              n_graphs=n)
        _assert_bf16_close(node_got, node_want)
        scale = np.zeros(want_out.shape[0])
        np.add.at(scale, np.asarray(r_batch["graph_ids"]),
                  np.abs(_np(node_want)))
        assert np.all(np.abs(_np(got_out) - _np(want_out))
                      <= BF16_TOL * (np.abs(_np(want_out)) + scale))
    else:
        _assert_bf16_close(got_out, want_out)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: RG.loss_fn(p, r_batch, r_cfg)[0]))(r_params)
    got_loss, got_grads = _port_grads(
        lambda p: PG.loss_fn(p, p_batch, p_cfg), p_params)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=(
        GRAPH_LOSS_RTOL if r_cfg.task == "graph" else LOSS_RTOL))
    _assert_grads_close(got_grads, want_grads)
    _, metrics = PG.loss_fn(p_params, p_batch, p_cfg)
    assert set(metrics) == ({"mse"} if r_cfg.task == "graph" else {"ce"})


@pytest.mark.parametrize("shape_name", ["molecule", "full_graph_sm"])
def test_node_embeddings_match_repro(shape_name):
    r_cfg, p_cfg, r_params, p_params, r_batch, p_batch = _setup(shape_name,
                                                                seed=1)
    got = PG.node_embeddings(p_params, p_batch, p_cfg)
    want = jax.jit(lambda p, b: RG.node_embeddings(p, b, r_cfg))(r_params,
                                                                 r_batch)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _assert_bf16_close(got, want)


def test_graph_forward_with_node_mask_and_explicit_n_graphs():
    r_cfg, p_cfg, r_params, p_params, r_batch, p_batch = _setup("molecule",
                                                                seed=2)
    mask = (np.arange(r_batch["positions"].shape[0]) % 3 != 0).astype(
        np.float32)
    r_batch = dict(r_batch, node_mask=jnp.asarray(mask))
    p_batch = dict(p_batch, node_mask=torch.from_numpy(mask))
    n = mask.shape[0]
    got = PG.forward(p_params, _per_node(p_batch, n, True), p_cfg,
                     n_graphs=n)
    want = RG.forward(r_params, _per_node(r_batch, n, False), r_cfg,
                      n_graphs=n)
    _assert_bf16_close(got, want)
    assert np.all(_np(got)[mask == 0] == 0)
    assert tuple(PG.forward(p_params, p_batch, p_cfg, n_graphs=6).shape) \
        == (6,)


def test_node_loss_without_label_mask_matches_repro():
    r_cfg, p_cfg, r_params, p_params, r_batch, p_batch = _setup(
        "full_graph_sm", seed=3)
    r_batch = {k: v for k, v in r_batch.items() if k != "label_mask"}
    p_batch = {k: v for k, v in p_batch.items() if k != "label_mask"}
    got, _ = PG.loss_fn(p_params, p_batch, p_cfg)
    want, _ = RG.loss_fn(r_params, r_batch, r_cfg)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_rbf_and_ssp_match_repro_f32():
    rng = np.random.default_rng(4)
    d = (np.abs(rng.standard_normal(200)) * 4).astype(np.float32)
    for n_rbf, cutoff in ((300, 10.0), (24, 10.0), (12, 5.0)):
        got = PG.rbf_expand(torch.from_numpy(d), n_rbf, cutoff)
        want = RG.rbf_expand(jnp.asarray(d), n_rbf, cutoff)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_RTOL, atol=1e-7)
    x = np.linspace(-30, 30, 301).astype(np.float32)
    np.testing.assert_allclose(PG.ssp(torch.from_numpy(x)).numpy(),
                               np.asarray(RG.ssp(jnp.asarray(x))),
                               rtol=F32_RTOL, atol=1e-6)


def test_spec_and_init_match_repro_structure():
    for cfg, r_cfg in ((CFG, R_CFG),
                       (dataclasses.replace(CFG, task="node", d_feat_in=24,
                                            n_classes=5),
                        dataclasses.replace(R_CFG, task="node", d_feat_in=24,
                                            n_classes=5))):
        got = PG.init(torch.Generator().manual_seed(0), cfg, CPU)
        want = RG.init(jax.random.PRNGKey(0), r_cfg)
        assert ([tuple(x.shape) for x in tree_leaves(got)]
                == [x.shape for x in jax.tree_util.tree_leaves(want)])


# ---------------------------------------------------------------------------
# repro's tests/test_models_gnn.py, replayed on the port (repro's params)
# ---------------------------------------------------------------------------


def _molecule_batch(rng, n_graphs=3, n_atoms=8, n_edges=20):
    n = n_graphs * n_atoms
    return {
        "positions": torch.from_numpy(
            rng.standard_normal((n, 3)).astype(np.float32)),
        "edge_index": torch.from_numpy(
            rng.integers(0, n, (2, n_edges * n_graphs)).astype(np.int32)),
        "atom_types": torch.from_numpy(
            rng.integers(0, 10, (n,)).astype(np.int32)),
        "graph_ids": torch.arange(n_graphs).repeat_interleave(n_atoms),
        "targets": torch.from_numpy(
            rng.standard_normal(n_graphs).astype(np.float32)),
    }


def _params(cfg, r_cfg):
    return _to_port(RG.init(jax.random.PRNGKey(0), r_cfg))


def test_graph_task_shapes_and_grads():
    batch = _molecule_batch(np.random.default_rng(0))
    params = _params(CFG, R_CFG)
    out = PG.forward(params, batch, CFG, n_graphs=3)
    assert tuple(out.shape) == (3,)
    _, grads = _port_grads(lambda p: PG.loss_fn(p, batch, CFG), params)
    gn = sum(float(g.abs().sum()) for g in tree_leaves(grads))
    assert np.isfinite(gn) and gn > 0


def test_node_task():
    cfg = dataclasses.replace(CFG, task="node", d_feat_in=24, n_classes=5)
    r_cfg = dataclasses.replace(R_CFG, task="node", d_feat_in=24,
                                n_classes=5)
    rng = np.random.default_rng(1)
    n, e = 50, 200
    batch = {
        "features": torch.from_numpy(
            rng.standard_normal((n, 24)).astype(np.float32)),
        "positions": torch.from_numpy(
            rng.standard_normal((n, 3)).astype(np.float32)),
        "edge_index": torch.from_numpy(
            rng.integers(0, n, (2, e)).astype(np.int32)),
        "labels": torch.from_numpy(rng.integers(0, 5, (n,)).astype(np.int32)),
        "label_mask": torch.ones(n),
    }
    params = _params(cfg, r_cfg)
    assert tuple(PG.forward(params, batch, cfg).shape) == (n, 5)
    loss, _ = PG.loss_fn(params, batch, cfg)
    assert np.isfinite(float(loss))


def test_message_passing_locality():
    """A node with no incoming edges keeps its embedding-derived state."""
    rng = np.random.default_rng(2)
    n = 10
    edges = np.zeros((2, 5), np.int32)
    edges[0] = [1, 2, 3, 4, 5]               # all edges point into node 0
    batch = {"positions": torch.from_numpy(
                 rng.standard_normal((n, 3)).astype(np.float32)),
             "edge_index": torch.from_numpy(edges),
             "atom_types": torch.zeros(n, dtype=torch.int32)}
    emb = PG.node_embeddings(_params(CFG, R_CFG), batch, CFG).numpy()
    np.testing.assert_allclose(emb[1], emb[9], rtol=1e-4)
    assert float(np.abs(emb[0] - emb[9]).max()) > 1e-4


def test_rbf_expansion():
    rbf = PG.rbf_expand(torch.tensor([0.0, 5.0, 10.0]), 20, 10.0)
    assert tuple(rbf.shape) == (3, 20)
    assert int(torch.argmax(rbf[0])) == 0
    assert int(torch.argmax(rbf[2])) == 19


def test_edge_mask_zeroes_messages():
    batch = _molecule_batch(np.random.default_rng(3))
    params = _params(CFG, R_CFG)
    masked = dict(batch, edge_mask=torch.zeros(batch["edge_index"].shape[1]))
    none = dict(batch,
                edge_index=torch.zeros_like(batch["edge_index"]),
                edge_mask=torch.zeros(batch["edge_index"].shape[1]))
    np.testing.assert_allclose(PG.node_embeddings(params, masked, CFG).numpy(),
                               PG.node_embeddings(params, none, CFG).numpy(),
                               rtol=1e-4, atol=1e-5)
