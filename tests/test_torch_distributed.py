"""The port's placement and communication against ``repro``'s on a mesh.

``repro``'s side runs once, in one subprocess with 8 forced host devices
(as ``tests/test_distributed.py`` runs it), and writes its results as
numpy arrays: the compressed gradient exchange's accumulated means over
20 steps of error feedback (none / int8 / 1-bit, 8 "data" shards), and
the MoE layer of REDUCED qwen3-moe under ``ShardingContext(make_test_mesh
(8, 2), SINGLE_POD_RULES)`` (4 dispatch groups) and without a context.

The port is held to ``repro``'s bars (error feedback's relative error
< 0.02 for int8 and < 0.35 for 1-bit), to ``repro``'s accumulated means
on the same grads (allclose 1e-6), to the MoE's bf16 bars (rtol = atol =
1.6e-2, aux loss 1e-3 relative), and to the local PCA fit (each |cos| of
the components within 1e-3 of 1).  The gathered-bytes counter of each
exchange must equal the codes plus the scales.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.configs import registry as p_reg  # noqa: E402
from repro_torch.core.pca import PCA, fit_pca_distributed  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402
from repro_torch.parallel.collectives import COUNTER  # noqa: E402
from repro_torch.parallel.compression_comm import (  # noqa: E402
    init_residual, int8_allmean, make_compressed_grad_exchange,
    onebit_allmean)
from repro_torch.parallel.sharding import (SINGLE_POD_RULES,  # noqa: E402
                                           ShardingContext)
from repro_torch.train.trainer import state_from_numpy  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
CPU = "cpu"
STEPS, SHARDS, DIM = 20, 8, 64
BARS = {"int8": 0.02, "onebit": 0.35}
BF16_TOL = 1.6e-2
LOSS_RTOL = 1e-3
MOE_T = 64

REPRO_SIDE = """
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, PartitionSpec as P
    from repro.configs.registry import get_arch
    from repro.launch.mesh import make_test_mesh
    from repro.models import layers as RL, moe as RM
    from repro.parallel.compat import shard_map
    from repro.parallel.compression_comm import make_compressed_grad_exchange
    from repro.parallel.sharding import SINGLE_POD_RULES, ShardingContext

    STEPS, SHARDS, DIM, T = {steps}, {shards}, {dim}, {t}
    out = {{}}
    grads = np.random.default_rng(2).standard_normal(
        (STEPS, SHARDS, DIM)).astype(np.float32)
    out["grads"] = grads
    mesh = make_test_mesh(8, model=1)

    def run(scheme):
        exchange = make_compressed_grad_exchange(scheme, "data")
        def one_host(gs):
            # a scan over the steps (one compiled body; repro's own test
            # unrolls them, which compiles for minutes on 8 host devices)
            def step(carry, g):
                res, acc = carry
                mean, res = exchange({{"w": g[0]}}, res)
                return (res, acc + mean["w"]), None
            init = (jnp.zeros((DIM,)), jnp.zeros((DIM,)))
            (_, acc), _ = jax.lax.scan(step, init, gs)
            return acc[None]
        fn = shard_map(one_host, mesh=mesh, in_specs=P(None, "data", None),
                       out_specs=P("data", None))
        return np.asarray(fn(jnp.asarray(grads)))[0]

    for scheme in ("none", "int8", "onebit"):
        out["acc_" + scheme] = run(scheme)

    cfg = get_arch("qwen3-moe-30b-a3b").reduced
    params = RL.init_params(jax.random.PRNGKey(0), RM.moe_spec(cfg))
    for k, v in params.items():
        out["p_" + k] = np.asarray(v)
    x = np.random.default_rng(3).standard_normal((T, cfg.d_model)).astype(
        np.float32)
    out["x"] = x
    moe = jax.jit(lambda p, x: RM.moe_ffn(p, x, cfg))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    o1, a1 = moe(params, xb)
    # make_test_mesh's (4, 2) mesh with Auto axes: jax 0.9 makes Explicit
    # axes by default, and repro's with_sharding_constraint needs Auto
    tmesh = jax.make_mesh((4, 2), ("data", "model"),
                          axis_types=(AxisType.Auto,) * 2)
    with ShardingContext(tmesh, SINGLE_POD_RULES):
        out["groups"] = np.asarray(RM._n_groups(T))
        o4, a4 = jax.jit(lambda p, x: RM.moe_ffn(p, x, cfg))(params, xb)
    for name, v in (("out_g1", o1), ("aux_g1", a1), ("out_g4", o4),
                    ("aux_g4", a4)):
        out[name] = np.asarray(jnp.asarray(v).astype(jnp.float32))
    np.savez(sys.argv[1], **out)
    print("REPRO_SIDE_OK")
"""


@pytest.fixture(scope="module")
def repro_side(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dist") / "repro.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    code = textwrap.dedent(REPRO_SIDE.format(steps=STEPS, shards=SHARDS,
                                             dim=DIM, t=MOE_T))
    run = subprocess.run([sys.executable, "-c", code, path],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    assert "REPRO_SIDE_OK" in run.stdout
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _accumulate(scheme, grads):
    """20 steps of the port's exchange over 8 "data" positions (of a 8×1
    mesh on the CPU); the accumulated mean."""
    mesh = make_test_mesh(8, 1, device=CPU)
    assert mesh.shape["data"] == SHARDS
    exchange = make_compressed_grad_exchange(scheme, "data")
    res = None if scheme == "none" else [
        init_residual({"w": torch.zeros(DIM)}) for _ in range(SHARDS)]
    acc = torch.zeros(DIM)
    for t in range(STEPS):
        mean, res = exchange([{"w": torch.from_numpy(grads[t, s])}
                              for s in range(SHARDS)], res)
        acc = acc + mean["w"]
    return acc.numpy()


@pytest.mark.parametrize("scheme", ["int8", "onebit"])
def test_compressed_exchange_meets_repro_bars(repro_side, scheme):
    exact = _accumulate("none", repro_side["grads"])
    approx = _accumulate(scheme, repro_side["grads"])
    rel = np.linalg.norm(approx - exact) / np.linalg.norm(exact)
    assert rel < BARS[scheme], (scheme, rel)


@pytest.mark.parametrize("scheme", ["none", "int8", "onebit"])
def test_compressed_exchange_matches_repro_means(repro_side, scheme):
    got = _accumulate(scheme, repro_side["grads"])
    np.testing.assert_allclose(got, repro_side["acc_" + scheme], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("n", [64, 1000, 4099])
def test_gathered_bytes_are_codes_plus_scales(n):
    vecs = [torch.from_numpy(np.random.default_rng(s).standard_normal(
        n).astype(np.float32)) for s in range(SHARDS)]
    COUNTER.reset()
    int8_allmean(vecs)
    assert COUNTER.bytes == {"all-gather": SHARDS * (n + 4)}
    COUNTER.reset()
    onebit_allmean(vecs)
    words = -(-n // 32)
    assert COUNTER.bytes == {"all-gather": SHARDS * (4 * words + 4)}
    COUNTER.reset()
    exchange = make_compressed_grad_exchange("none")
    exchange([{"w": v} for v in vecs], None)
    assert COUNTER.bytes == {"all-reduce": 4 * n}
    exchange = make_compressed_grad_exchange("int8")
    COUNTER.reset()
    exchange([{"a": v[: n // 2], "b": v[n // 2:]} for v in vecs], None)
    assert COUNTER.total() == SHARDS * (n + 4)
    COUNTER.reset()


def test_exchange_keeps_tree_and_residual_per_shard():
    grads = [{"w": torch.full((3, 2), float(s)), "b": torch.ones(2)}
             for s in range(4)]
    mean, res = make_compressed_grad_exchange("int8")(grads, None)
    assert mean["w"].shape == (3, 2) and mean["b"].shape == (2,)
    assert len(res) == 4 and all(r.shape == (8,) for r in res)
    np.testing.assert_allclose(mean["w"].numpy(), 1.5, rtol=1e-2)


def test_distributed_pca_matches_local():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((800, 24)).astype(np.float32))
    mesh = make_test_mesh(8, model=2, device=CPU)           # data = 4
    shards = list(torch.chunk(x, mesh.shape["data"]))
    dist = fit_pca_distributed(shards, 6, mesh)
    local = PCA(6).fit(x)
    cos = np.abs(np.sum(dist.state["components"].numpy()
                        * local.state["components"].numpy(), axis=0))
    np.testing.assert_allclose(cos, 1.0, atol=1e-3)
    with pytest.raises(ValueError, match="positions"):
        fit_pca_distributed(shards[:3], 6, mesh)


def _port_moe(repro_side, ctx):
    cfg = p_reg.get_arch("qwen3-moe-30b-a3b").reduced
    params = state_from_numpy({k[2:]: v for k, v in repro_side.items()
                               if k.startswith("p_")}, CPU)
    x = torch.from_numpy(repro_side["x"]).to(torch.bfloat16)
    if ctx is None:
        return PM.moe_ffn(params, x, cfg) + (PM._n_groups(MOE_T),)
    with ctx:
        return PM.moe_ffn(params, x, cfg) + (PM._n_groups(MOE_T),)


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_moe_under_mesh_uses_repro_groups(repro_side):
    mesh = make_test_mesh(8, 2, device=CPU)
    out, aux, g = _port_moe(repro_side,
                            ShardingContext(mesh, SINGLE_POD_RULES))
    assert g == int(repro_side["groups"]) == 4
    _close(out, repro_side["out_g4"])
    np.testing.assert_allclose(float(aux), float(repro_side["aux_g4"]),
                               rtol=LOSS_RTOL)


def test_moe_without_mesh_is_one_group(repro_side):
    out, aux, g = _port_moe(repro_side, None)
    assert g == 1
    _close(out, repro_side["out_g1"])
    np.testing.assert_allclose(float(aux), float(repro_side["aux_g1"]),
                               rtol=LOSS_RTOL)


def test_moe_groups_change_the_drops(repro_side):
    """With 4 groups each group's capacity is a quarter of the whole
    batch's, so other tokens are dropped: the outputs differ (in both
    packages), which is why the group count must follow the mesh."""
    mesh = make_test_mesh(8, 2, device=CPU)
    out4, _, _ = _port_moe(repro_side,
                           ShardingContext(mesh, SINGLE_POD_RULES))
    out1, _, _ = _port_moe(repro_side, None)
    diff = np.abs(out4.float().numpy() - out1.float().numpy()).max(axis=1)
    want = np.abs(repro_side["out_g4"] - repro_side["out_g1"]).max(axis=1)
    assert (diff > BF16_TOL).any() and (want > BF16_TOL).any()
    np.testing.assert_array_equal(diff > 0.1, want > 0.1)


def test_elastic_resume_keeps_the_global_batch(tmp_path):
    """A REDUCED two-tower run checkpointed on data=8, restored onto
    ``plan_remesh``'s 4-device mesh with ``reshard_state`` and resumed at
    ``microbatch_scale`` × the microbatches ends on the uninterrupted
    run's losses: one microbatch a data position (8 before, 4 × 2 after),
    so the same shares of the same global batch."""
    import functools

    from repro_torch.data.batches import make_batch
    from repro_torch.launch.steps import _ctx_loss, build_step
    from repro_torch.models import layers as PLy
    from repro_torch.models import recsys as PR
    from repro_torch.train import optimizer as PO
    from repro_torch.train import trainer as PT
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.elastic import (build_mesh, plan_remesh,
                                           reshard_state)

    arch = p_reg.get_arch("two-tower-retrieval")
    shape, cfg = arch.shape("train_batch"), arch.reduced
    plan = plan_remesh({"data": 8, "model": 1}, 4)
    assert plan.new_shape == {"data": 4, "model": 1}
    old, new = build_mesh(plan.old_shape, CPU), build_mesh(plan.new_shape,
                                                           CPU)
    tx = PO.OptimizerConfig(lr=1e-3, total_steps=10000).build()

    def step_on(mesh, micro):
        return PT.make_train_step(functools.partial(
            _ctx_loss, PR.two_tower_loss, cfg, mesh, SINGLE_POD_RULES), tx,
            microbatches=micro)

    step_old = step_on(old, old.shape["data"])
    step_new = step_on(new, new.shape["data"] * plan.microbatch_scale)
    state0 = PT.init_state(torch.Generator().manual_seed(0), lambda g:
                           PLy.init_params(g, PR.two_tower_spec(cfg), CPU),
                           tx)
    batches = [make_batch(np.random.default_rng(i), arch, shape,
                          reduced=True, device=CPU) for i in range(6)]
    s, want = state0, []
    for b in batches:
        s, m = step_old(s, b)
        want.append(float(m["loss"]))
    s, got = state0, []
    for b in batches[:3]:
        s, m = step_old(s, b)
        got.append(float(m["loss"]))
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(s, 3, blocking=True)
    specs = build_step(arch, shape, new, SINGLE_POD_RULES,
                       reduced=True).in_specs[0]
    s = reshard_state(ck.restore(s, device=CPU), specs, new)
    for b in batches[3:]:
        s, m = step_new(s, b)
        got.append(float(m["loss"]))
    assert got == want and int(s["step"]) == 6
