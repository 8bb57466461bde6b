"""``repro_torch.parallel.sharding`` and ``repro_torch.train.elastic``
against ``repro``'s.

``repro``'s ``tests/test_sharding.py`` (10 tests) replayed on the port;
then the port's specs held to ``repro``'s, as tuples, for every leaf of
every cell's FULL step bundle (parameters, optimizer state, caches,
index state, batch) on both production meshes, duck-typed as
``FakeMesh``; ``plan_remesh`` over a grid; and the port's own mesh
helpers (``build_mesh``, ``reshard_state``, ``logical_to_spec``).
"""

import jax
import pytest
from jax.sharding import PartitionSpec as JP

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs import registry as r_reg  # noqa: E402
from repro.launch import steps as r_steps  # noqa: E402
from repro.parallel import sharding as r_sh  # noqa: E402
from repro.train import elastic as r_el  # noqa: E402
from repro_torch.configs import registry as p_reg  # noqa: E402
from repro_torch.launch import steps as p_steps  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.parallel.sharding import (MULTI_POD_RULES,  # noqa: E402
                                           SINGLE_POD_RULES, AxisRules,
                                           PartitionSpec as P,
                                           ShardingContext, logical_to_spec,
                                           shard, shard_constraint,
                                           spec_for_shape)
from repro_torch.train.elastic import (build_mesh, plan_remesh,  # noqa: E402
                                       reshard_state)


class FakeMesh:
    """Duck-typed mesh: spec_for_shape only reads .shape dict."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH = FakeMesh(data=16, model=16)
POD_MESH = FakeMesh(pod=2, data=16, model=16)


# ---------------------------------------------------------------------------
# repro's tests/test_sharding.py, on the port
# ---------------------------------------------------------------------------


def test_basic_mapping():
    spec = spec_for_shape((256, 4096), ("batch", None), SINGLE_POD_RULES,
                          MESH)
    assert spec == P("data")


def test_divisibility_guard_drops_axis():
    spec = spec_for_shape((3072, 24, 128), ("fsdp", "heads", None),
                          SINGLE_POD_RULES, MESH)
    assert spec == P("data")
    spec = spec_for_shape((3072, 48, 128), ("fsdp", "heads", None),
                          SINGLE_POD_RULES, MESH)
    assert spec == P("data", "model")


def test_no_axis_reuse():
    spec = spec_for_shape((256, 4096, 1024), ("batch", "fsdp", "ff"),
                          SINGLE_POD_RULES, MESH)
    assert spec == P("data", None, "model")


def test_multi_pod_tuple_axes():
    spec = spec_for_shape((256, 4096), ("batch", None), MULTI_POD_RULES,
                          POD_MESH)
    assert spec == P(("pod", "data"))


def test_tuple_axis_prefix_fallback():
    spec = spec_for_shape((16, 8), ("batch", None), MULTI_POD_RULES, POD_MESH)
    assert spec in (P(("pod",)), P(("pod", "data")))
    size = 2 if spec == P(("pod",)) else 32
    assert 16 % size == 0


def test_rules_replace():
    r = SINGLE_POD_RULES.replace(kv_seq="model")
    assert r.get("kv_seq") == "model"
    assert SINGLE_POD_RULES.get("kv_seq") is None


def test_no_mesh_is_unsharded():
    assert spec_for_shape((8, 8), ("batch", None), SINGLE_POD_RULES,
                          None) == P()


def test_plan_remesh_preserves_model_axis():
    plan = plan_remesh({"data": 16, "model": 16}, n_devices=128)
    assert plan.new_shape == {"data": 8, "model": 16}
    assert plan.microbatch_scale == 2


def test_plan_remesh_shrinks_model_axis_if_needed():
    plan = plan_remesh({"data": 16, "model": 16}, n_devices=24)
    assert plan.new_shape["model"] * plan.new_shape["data"] <= 24
    assert 24 % plan.new_shape["model"] == 0


def test_plan_remesh_multi_pod_merge():
    plan = plan_remesh({"pod": 2, "data": 16, "model": 16}, n_devices=256)
    assert plan.new_shape == {"data": 16, "model": 16}
    assert plan.microbatch_scale == 2


# ---------------------------------------------------------------------------
# the port's specs against repro's
# ---------------------------------------------------------------------------


def test_partition_spec_keeps_repro_equality():
    assert P("a") != P(("a",))
    assert tuple(P("a", None)) == tuple(JP("a", None))
    assert tuple(P(("pod", "data"))) == tuple(JP(("pod", "data")))
    assert spec_for_shape((4, 8), ("batch", None), SINGLE_POD_RULES,
                          MESH) == P()                # trailing None dropped


def test_rule_tables_equal_repro():
    for ours, theirs in ((SINGLE_POD_RULES, r_sh.SINGLE_POD_RULES),
                         (MULTI_POD_RULES, r_sh.MULTI_POD_RULES)):
        assert ours.rules == theirs.rules


CELLS = [(a, s.name) for a in p_reg.ALL_NAMES
         for s in p_reg.get_arch(a).shapes]
MESHES = {"16x16": (MESH, r_sh.SINGLE_POD_RULES, SINGLE_POD_RULES),
          "2x16x16": (POD_MESH, r_sh.MULTI_POD_RULES, MULTI_POD_RULES)}


def _repro_specs(tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _port_specs(tree):
    return [tuple(s) for _, s in p_steps._flat_with_paths(tree)]


def _as_jax_stores(spec: tuple) -> tuple:
    """jax 0.9's ``PartitionSpec`` stores a one-axis tuple as the axis name
    (``P(("a",)) == P("a")`` there); the port keeps the rule's form, as
    ``repro``'s ``spec_for_shape`` writes it.  Map the port's one-axis
    tuples to names before comparing element by element."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in spec)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("cell", CELLS, ids=[f"{a}:{s}" for a, s in CELLS])
def test_bundle_specs_equal_repro(cell, mesh_name):
    """Every FULL parameter, optimizer-state, cache and index leaf, and
    every batch leaf, gets ``repro``'s spec on the production mesh."""
    mesh, r_rules, p_rules = MESHES[mesh_name]
    arch_name, shape_name = cell
    r_arch = r_reg.get_arch(arch_name)
    p_arch = p_reg.get_arch(arch_name)
    want = r_steps.build_step(r_arch, r_arch.shape(shape_name), mesh,
                              r_rules)
    got = p_steps.build_step(p_arch, p_arch.shape(shape_name), mesh,
                             p_rules)
    for w, g in zip(want.in_specs, got.in_specs):
        ws, gs = _repro_specs(w), _port_specs(g)
        assert len(ws) == len(gs)
        assert [_as_jax_stores(x) for x in gs] == ws
    # the batch leaves by name, through the port's own helper
    r_batch = want.abstract_args[-1]
    p_batch = got.abstract_args[-1]
    assert {k: tuple(v.shape) for k, v in p_batch.items()} == \
        {k: tuple(v.shape) for k, v in r_batch.items()}
    assert want.donate == got.donate


@pytest.mark.parametrize("arch_name", p_reg.ARCH_NAMES)
def test_param_spec_leaves_equal_repro(arch_name):
    """``spec_for_shape`` leaf by leaf over each FULL ParamSpec tree, with
    both rule tables and the parallel-mode rules, on both meshes
    (paper-dpr has no ParamSpec tree: its index state is held in
    :func:`test_bundle_specs_equal_repro`)."""
    from repro.models import gnn as RG, recsys as RR, transformer as RT
    from repro_torch.models import gnn as PG, recsys as PR
    r_arch, p_arch = r_reg.get_arch(arch_name), p_reg.get_arch(arch_name)
    fam = p_arch.family
    if fam == "lm":
        trees = [(RT.lm_spec(r_arch.model), PT.lm_spec(p_arch.model))]
    elif fam == "gnn":
        trees = [(RG.schnet_spec(r_arch.model), PG.schnet_spec(p_arch.model))]
    else:
        name = type(p_arch.model).__name__
        fn = {"TwoTowerConfig": "two_tower_spec", "FMConfig": "fm_spec",
              "DINConfig": "din_spec", "DCNConfig": "dcn_spec"}[name]
        trees = [(getattr(RR, fn)(r_arch.model),
                  getattr(PR, fn)(p_arch.model))]
    n = 0
    for r_tree, p_tree in trees:
        r_leaves = jax.tree_util.tree_leaves(
            r_tree, is_leaf=lambda x: hasattr(x, "axes"))
        p_leaves = [s for _, s in p_steps._flat_with_paths(p_tree)]
        assert len(r_leaves) == len(p_leaves)
        for mesh, r_rules, p_rules in (
                (MESH, r_sh.SINGLE_POD_RULES, SINGLE_POD_RULES),
                (POD_MESH, r_sh.MULTI_POD_RULES, MULTI_POD_RULES)):
            full = tuple(a for a in ("pod", "data", "model")
                         if a in mesh.axis_names)
            fsdp = dict(batch=full, fsdp=full, heads=None, kv_heads=None,
                        ff=None, experts=None, vocab=full)
            for rr, pr in ((r_rules, p_rules),
                           (r_rules.replace(**fsdp), p_rules.replace(**fsdp))):
                for rl, pl in zip(r_leaves, p_leaves):
                    assert tuple(pl.shape) == tuple(rl.shape)
                    assert tuple(pl.axes) == tuple(rl.axes)
                    got = spec_for_shape(pl.shape, pl.axes, pr, mesh)
                    want = r_sh.spec_for_shape(rl.shape, rl.axes, rr, mesh)
                    assert _as_jax_stores(got) == tuple(want)
                    n += 1
    assert n > 0


OLD_SHAPES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
              {"data": 8, "model": 1}, {"data": 4, "model": 8},
              {"data": 2, "model": 3}, {"model": 16}, {"data": 32})


@pytest.mark.parametrize("old", OLD_SHAPES, ids=str)
def test_plan_remesh_equals_repro(old):
    for n in (1, 2, 3, 4, 6, 8, 12, 16, 24, 48, 64, 100, 128, 256, 512):
        got, want = plan_remesh(old, n), r_el.plan_remesh(old, n)
        assert got.new_shape == want.new_shape
        assert got.microbatch_scale == want.microbatch_scale
        assert got.data_scale == want.data_scale


# ---------------------------------------------------------------------------
# the port's mesh helpers
# ---------------------------------------------------------------------------


def test_logical_to_spec_and_identity_constraints():
    spec_tree = PT.lm_spec(p_reg.get_arch("dbrx-132b").model)
    specs = logical_to_spec(PL.logical_axes(spec_tree),
                            PL.abstract_params(spec_tree), SINGLE_POD_RULES,
                            MESH)
    want = p_steps._tree_specs(spec_tree, SINGLE_POD_RULES, MESH)
    assert _port_specs(specs) == _port_specs(want)
    assert any(len(s) for s in _port_specs(specs))
    x = torch.arange(6.0).reshape(2, 3)
    with ShardingContext(MESH, SINGLE_POD_RULES):
        assert shard(x, "batch", None) is x
        assert shard_constraint(x, ("batch", None), SINGLE_POD_RULES,
                                MESH) is x
        assert ShardingContext.current().mesh is MESH
    assert ShardingContext.current() is None


def test_build_mesh_device_rule():
    mesh = build_mesh({"data": 4, "model": 2}, "cpu")
    assert mesh.shape == {"data": 4, "model": 2}
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    with pytest.raises(ValueError, match="need 8 devices"):
        build_mesh({"data": 4, "model": 2}, ["cpu", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_mesh({"data": 2})
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_test_mesh(8, 2)


def test_reshard_state_moves_and_checks_axes():
    state = {"params": {"w": torch.ones(8, 4), "b": torch.zeros(4)},
             "opt": (torch.zeros(8, 4),),
             "step": torch.zeros((), dtype=torch.int32)}
    specs = {"params": {"w": P("data"), "b": P()}, "opt": (P("data"),),
             "step": P()}
    new = build_mesh({"data": 4, "model": 1}, "cpu")
    out = reshard_state(state, specs, new)
    assert torch.equal(out["params"]["w"], state["params"]["w"])
    assert isinstance(out["opt"], tuple)
    bad = dict(specs, params={"w": P("pod"), "b": P()})
    with pytest.raises(ValueError, match="'pod'"):
        reshard_state(state, bad, new)


def test_custom_rules_are_port_rules():
    r = AxisRules((("batch", ("pod", "data")),))
    assert spec_for_shape((64, 3), ("batch", None), r, POD_MESH) \
        == P(("pod", "data"))
