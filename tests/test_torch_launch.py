"""``repro_torch.launch`` (step builder, roofline, dry run) against
``repro.launch``.

- All 42 cells of ``tests/test_configs_smoke.py`` through the port's
  ``build_step`` on the CPU: REDUCED configs, one real step, finite, and
  ``repro``'s shape checks.
- One cell of each step family against ``repro``'s bundle on the same
  numpy parameters and batch: lm_train, lm_prefill, lm_decode, gnn,
  recsys_train, recsys_serve, retrieval_cand (the port's bf16 bars:
  losses within 1e-3 relative, outputs at rtol 1.6e-2 with atol
  1.6e-2·max|·|; a ranked id scores, by the other package's scores,
  within twice the values' largest difference of the other's id at its
  rank); and the paper's KB search step, naive and two_stage × int8,
  1-bit and fp32 (a bf16 product with f32 sums): ids equal, 1-bit score
  bits equal, int8 and fp32 scores within ``tests/test_kernels.py``'s
  int8 bar (atol 0.02·max); the port's two_stage
  over a mesh (2 and 8 doc shards) equal to its no-mesh run bit for bit.
- The dry run: a reduced dbrx train_4k on ``make_test_mesh(8, 2)`` over
  meta tensors (FLOPs > 0, some parameter sharded, the same FLOPs as the
  step on CPU tensors), and ``run_cell`` / the CLI's sweep on FULL cells.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs import registry as r_reg  # noqa: E402
from repro.data import batches as r_batches  # noqa: E402
from repro.launch import steps as r_steps  # noqa: E402
from repro_torch.configs import registry as p_reg  # noqa: E402
from repro_torch.data import batches as p_batches  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch import steps as p_steps  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     make_test_mesh, rules_for_mesh)
from repro_torch.parallel.sharding import (MULTI_POD_RULES,  # noqa: E402
                                           SINGLE_POD_RULES)
from repro_torch.train import optimizer as PO  # noqa: E402
from repro_torch.train.elastic import build_mesh  # noqa: E402

CPU = "cpu"
BF16_TOL = 1.6e-2
LOSS_RTOL = 1e-3
CELLS = [(a, s.name) for a in p_reg.ALL_NAMES
         for s in p_reg.get_arch(a).shapes]


def _finite(tree) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in PO.tree_leaves(tree)
               if isinstance(x, torch.Tensor) and x.dtype.is_floating_point)


def _materialize(bundle, seed=0):
    """Concrete CPU arguments for a bundle: params N(0, 0.02²) in their
    dtypes, optimizer state zeros (Adam's second moment is a variance),
    as ``repro``'s smoke test makes them."""
    g = torch.Generator().manual_seed(seed)

    def mat(x, zeros=False):
        if not isinstance(x, torch.Tensor):
            return x
        if not zeros and x.dtype.is_floating_point:
            return (torch.randn(x.shape, generator=g) * 0.02).to(x.dtype)
        return torch.zeros(x.shape, dtype=x.dtype)

    args = []
    for a in bundle.abstract_args[:-1]:
        if isinstance(a, dict) and "opt" in a:
            args.append({"params": PO.tree_map(mat, a["params"]),
                         "opt": PO.tree_map(lambda x: mat(x, True), a["opt"]),
                         "step": torch.zeros((), dtype=torch.int32)})
        else:
            args.append(PO.tree_map(mat, a))
    return args


@pytest.mark.parametrize("arch_name,shape_name", CELLS,
                         ids=[f"{a}:{s}" for a, s in CELLS])
def test_cell_smoke(arch_name, shape_name):
    arch = p_reg.get_arch(arch_name)
    shape = arch.shape(shape_name)
    bundle = p_steps.build_step(arch, shape, mesh=None, rules=None,
                                reduced=True)
    batch = p_batches.make_batch(np.random.default_rng(42), arch, shape,
                                 reduced=True, device=CPU)
    out = bundle.fn(*_materialize(bundle), batch)
    assert _finite(out), f"NaNs in {arch_name}:{shape_name}"
    if shape.kind == "lm_train":
        _, metrics = out
        assert float(metrics["loss"]) > 0
    elif shape.kind == "lm_decode":
        logits, _ = out
        dims = p_batches.reduce_dims(shape)
        assert logits.shape == (dims["global_batch"],
                                arch.reduced.vocab_size)
    elif shape.kind == "retrieval_cand":
        vals, _ = out
        assert vals.shape[0] >= 1


def test_all_ten_archs_present():
    assert len(p_reg.ARCH_NAMES) == 10
    assert len(CELLS) == 10 * 4 + 2


# ---------------------------------------------------------------------------
# parity with repro's bundles
# ---------------------------------------------------------------------------


def _same_inputs(r_bundle, p_bundle, seed=0):
    """The same numpy values into both bundles' argument trees (leaf for
    leaf, in ``jax.tree_util`` order), and ``repro``'s batch."""
    rng = np.random.default_rng(seed)
    r_args, p_args = [], []
    for r_a, p_a in zip(r_bundle.abstract_args[:-1],
                        p_bundle.abstract_args[:-1]):
        r_leaves = jax.tree_util.tree_leaves(r_a)
        p_leaves = PO.tree_leaves(p_a)
        assert len(r_leaves) == len(p_leaves)
        opt_n = (len(jax.tree_util.tree_leaves(r_a["opt"]))
                 if isinstance(r_a, dict) and "opt" in r_a else 0)
        n_params = (len(jax.tree_util.tree_leaves(r_a["params"]))
                    if opt_n else len(r_leaves))
        # dict keys sort "opt" < "params" < "step"
        vals = []
        for i, (r, p) in enumerate(zip(r_leaves, p_leaves)):
            assert tuple(r.shape) == tuple(p.shape)
            is_param = (opt_n <= i < opt_n + n_params) if opt_n else True
            if is_param and jnp.issubdtype(r.dtype, jnp.floating):
                vals.append((rng.standard_normal(r.shape) * 0.02
                             ).astype(np.float32))
            else:
                vals.append(np.zeros(r.shape, np.float32 if jnp.issubdtype(
                    r.dtype, jnp.floating) else np.int32))
        r_args.append(jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(r_a),
            [jnp.asarray(v).astype(r.dtype) for v, r in zip(vals, r_leaves)]))
        p_args.append(PO.tree_unflatten(
            p_a, [torch.from_numpy(v).to(p.dtype)
                  for v, p in zip(vals, p_leaves)]))
    return r_args, p_args


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_scaled(got, want, tol=BF16_TOL):
    g, w = _np(got), _np(want)
    np.testing.assert_allclose(g, w, rtol=tol,
                               atol=tol * max(float(np.abs(w).max()), 1e-12))


def _rankings_agree(g_ids, w_ids, g_full, w_full, g_vals, w_vals):
    """Each package's j-th id scores, by the other package's scores, within
    twice the values' largest difference of the other's j-th value: the
    two rankings differ only where scores lie closer than the packages'
    own disagreement."""
    eps = 2 * float(np.abs(_np(g_vals) - _np(w_vals)).max())
    g_ids, w_ids = np.asarray(g_ids).astype(np.int64), np.asarray(w_ids)
    g_full, w_full = _np(g_full), _np(w_full)
    assert (np.take_along_axis(w_full, g_ids, 1) >= _np(w_vals) - eps).all()
    assert (np.take_along_axis(g_full, w_ids.astype(np.int64), 1)
            >= _np(g_vals) - eps).all()
    assert (g_ids[:, 0] == w_ids[:, 0]).all()


PARITY = {"lm_train": ("phi4-mini-3.8b", "train_4k"),
          "lm_prefill": ("qwen1.5-4b", "prefill_32k"),
          "lm_decode": ("phi4-mini-3.8b", "decode_32k"),
          "gnn": ("schnet", "full_graph_sm"),
          "recsys_train": ("fm", "train_batch"),
          "recsys_serve": ("dcn-v2", "serve_p99"),
          "retrieval_cand": ("two-tower-retrieval", "retrieval_cand")}


@pytest.mark.parametrize("family", list(PARITY))
def test_bundle_matches_repro(family):
    arch_name, shape_name = PARITY[family]
    r_arch, p_arch = r_reg.get_arch(arch_name), p_reg.get_arch(arch_name)
    r_shape, p_shape = r_arch.shape(shape_name), p_arch.shape(shape_name)
    r_b = r_steps.build_step(r_arch, r_shape, None, None, reduced=True)
    p_b = p_steps.build_step(p_arch, p_shape, None, None, reduced=True)
    r_args, p_args = _same_inputs(r_b, p_b)
    batch = r_batches.make_batch(np.random.default_rng(42), r_arch, r_shape,
                                 reduced=True)
    p_batch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    want = r_b.jit()(*r_args, batch)
    got = p_b.fn(*p_args, p_batch)
    if family in ("lm_train", "gnn", "recsys_train"):
        (_, w_m), (g_state, g_m) = want, got
        np.testing.assert_allclose(float(g_m["loss"]), float(w_m["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(g_m["grad_norm"]),
                                   float(w_m["grad_norm"]), rtol=BF16_TOL)
        assert int(g_state["step"]) == 1
    elif family in ("lm_prefill", "lm_decode"):
        (w_logits, w_cache), (g_logits, g_cache) = want, got
        _close_scaled(g_logits, w_logits)
        for g, w in zip(g_cache, w_cache):
            _close_scaled(g, w)
    elif family == "recsys_serve":
        _close_scaled(got, want)
    else:
        from repro.models import recsys as RR
        from repro_torch.models import recsys as PR
        (w_vals, w_ids), (g_vals, g_ids) = want, got
        _close_scaled(g_vals, w_vals)
        w_full = RR.retrieval_scores(r_args[0], batch, r_arch.reduced)
        g_full = PR.retrieval_scores(p_args[0], p_batch, p_arch.reduced)
        _rankings_agree(g_ids.numpy(), w_ids, g_full, w_full, g_vals, w_vals)


def _kb_variant(reg, storage, topk_impl):
    arch = reg.get_arch("paper-dpr")
    # small chunks, so two_stage streams 4 query chunks × 4 doc blocks
    cfg = dataclasses.replace(arch.reduced, storage=storage,
                              topk_impl=topk_impl, query_chunk=20,
                              doc_chunk=1000)
    return dataclasses.replace(arch, reduced=cfg)


def _kb_state(storage, seed=0):
    rng = np.random.default_rng(seed)
    n, d, dc, q = 4096, 768, 128, 64
    scale = rng.uniform(0.002, 0.01, dc).astype(np.float32)
    state = {"mu1": (rng.standard_normal(d) * 0.1).astype(np.float32),
             "w": (rng.standard_normal((d, dc)) / np.sqrt(d)
                   ).astype(np.float32),
             "mu2": (rng.standard_normal(dc) * 0.01).astype(np.float32),
             "scale": scale, "zero": (-127.5 * scale).astype(np.float32)}
    if storage == "int8":
        state["storage"] = rng.integers(0, 256, (n, dc)).astype(np.uint8)
    elif storage == "fp32":
        state["storage"] = rng.standard_normal((n, dc)).astype(np.float32)
    else:
        state["storage"] = rng.integers(0, 2 ** 32, (n, dc // 32),
                                        dtype=np.uint64).astype(np.uint32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    return state, queries


def _to_port(state):
    out = {k: torch.from_numpy(v) for k, v in state.items()
           if k != "storage"}
    st = state["storage"]
    out["storage"] = torch.from_numpy(st.view(np.int32) if st.dtype
                                      == np.uint32 else st)
    return out


@pytest.mark.parametrize("topk_impl", ["naive", "two_stage"])
@pytest.mark.parametrize("storage", ["int8", "onebit", "fp32"])
def test_kb_search_matches_repro(storage, topk_impl):
    r_arch = _kb_variant(r_reg, storage, topk_impl)
    p_arch = _kb_variant(p_reg, storage, topk_impl)
    shape = "search_exact"
    r_b = r_steps.build_step(r_arch, r_arch.shape(shape), None, None,
                             reduced=True)
    p_b = p_steps.build_step(p_arch, p_arch.shape(shape), None, None,
                             reduced=True)
    state, queries = _kb_state(storage)
    assert tuple(p_b.abstract_args[0]["storage"].shape) == \
        state["storage"].shape
    w_vals, w_ids = r_b.jit()({k: jnp.asarray(v) for k, v in state.items()},
                              {"queries": jnp.asarray(queries)})
    g_vals, g_ids = p_b.fn(_to_port(state),
                           {"queries": torch.from_numpy(queries)})
    np.testing.assert_array_equal(g_ids.numpy(), np.asarray(w_ids))
    if storage == "onebit":
        np.testing.assert_array_equal(g_vals.numpy().view(np.int32),
                                      np.asarray(w_vals).view(np.int32))
    else:
        scale = float(np.abs(np.asarray(w_vals)).max())
        np.testing.assert_allclose(g_vals.numpy(), np.asarray(w_vals),
                                   atol=0.02 * scale)

    # the same step over a mesh: 2 doc shards (16 rows padded: none), and
    # 8 on a pod mesh; ids and score bits equal to the run without one
    for mesh, rules in ((make_test_mesh(8, 2, device=CPU), SINGLE_POD_RULES),
                        (build_mesh({"pod": 2, "data": 2, "model": 4}, CPU),
                         MULTI_POD_RULES)):
        b = p_steps.build_step(p_arch, p_arch.shape(shape), mesh, rules,
                               reduced=True)
        m_vals, m_ids = b.fn(_to_port(state),
                             {"queries": torch.from_numpy(queries)})
        assert torch.equal(m_ids, g_ids)
        assert torch.equal(m_vals.view(torch.int32), g_vals.view(torch.int32))


def test_kb_search_merge_counts_its_gather():
    arch = _kb_variant(p_reg, "int8", "two_stage")
    mesh = make_test_mesh(8, 2, device=CPU)
    b = p_steps.build_step(arch, arch.shape("search_exact"), mesh,
                           SINGLE_POD_RULES, reduced=True)
    state, queries = _kb_state("int8")
    flops, _, coll, _ = roofline.count_step(
        b.fn, (_to_port(state), {"queries": torch.from_numpy(queries)}))
    k = p_batches.reduce_dims(arch.shape("search_exact"))["k"]
    assert coll == {"all-gather": 64 * 2 * k * (4 + 8)}
    assert flops >= 2 * 64 * 4096 * 128


# ---------------------------------------------------------------------------
# roofline and dry run
# ---------------------------------------------------------------------------


def test_small_mesh_dryrun_lm():
    """Reduced dbrx train_4k on an 8-position mesh over meta tensors."""
    mesh = make_test_mesh(8, model=2, device="meta")
    arch = p_reg.get_arch("dbrx-132b")
    bundle = p_steps.build_step(arch, arch.shape("train_4k"), mesh,
                                SINGLE_POD_RULES, reduced=True)
    report = roofline.analyze(bundle.name, "4x2", 8, bundle.fn,
                              bundle.abstract_args,
                              bundle.model_flops_fn(),
                              collectives=bundle.counts_collectives)
    assert report.hlo_gflops > 0 and report.hlo_gbytes > 0
    assert report.t_collective is None and report.coll_gbytes is None
    assert report.bottleneck in ("compute", "memory")
    params = bundle.in_specs[0]["params"]
    assert any(len(s) for _, s in p_steps._flat_with_paths(params))
    assert bundle.per_device_arg_bytes(mesh) < \
        bundle.per_device_arg_bytes(None)
    # the same step on CPU tensors counts the same FLOPs
    cpu_args = _materialize(bundle) + [p_batches.make_batch(
        np.random.default_rng(0), arch, arch.shape("train_4k"),
        reduced=True, device=CPU)]
    flops, nbytes, _, out = roofline.count_step(bundle.fn, tuple(cpu_args))
    assert flops == int(round(report.hlo_gflops * 1e9))
    assert _finite(out)


def test_roofline_terms_at_h100_rates():
    r = roofline.RooflineReport(
        name="x", mesh="16x16", chips=256, hlo_gflops=989e3 * 256,
        hlo_gbytes=3.35e3 * 256 * 2, coll_gbytes=450 * 256 * 3,
        per_collective={}, model_gflops=989e3 * 128,
        peak_memory_bytes=None)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(2.0)
    assert r.t_collective == pytest.approx(3.0)
    assert r.bottleneck == "collective"
    assert r.roofline_fraction == pytest.approx(0.5 / 3.0)
    r.coll_gbytes = None
    assert r.bottleneck == "memory" and r.step_time == pytest.approx(2.0)
    assert r.to_dict()["t_collective_s"] is None
    assert roofline.card_rates("NVIDIA H100 80GB HBM3") == \
        roofline.CARDS["H100"]
    assert roofline.card_rates("NVIDIA H100 PCIe")[0] == 2.0e12


def test_run_cell_full_kb_search_on_both_meshes():
    rows = {mp: dryrun.run_cell("paper-dpr", "search_exact", mp,
                                device=CPU, verbose=False)
            for mp in (False, True)}
    for mp, r in rows.items():
        shards = 32 if mp else 16
        assert r["status"] == "ok" and r["fits_hbm"]
        assert r["per_collective"] == {"all-gather": 6000 * shards * 16 * 12}
        assert r["t_collective_s"] is not None
        assert r["hlo_gflops"] == pytest.approx(r["model_gflops"], rel=0.01)
        assert r["peak_note"] == dryrun.PEAK_NOTE
    # 2,100,000 docs padded to 2,100,224; the codes split over the shards
    assert rows[False]["peak_memory_bytes"] >= 2_100_224 * 128 // 16
    assert rows[True]["chips"] == 512 and rows[False]["chips"] == 256


def test_dryrun_sweep_cli(tmp_path):
    out = str(tmp_path / "rows.jsonl")
    failures = dryrun.sweep([("fm", "serve_p99", "single"),
                             ("schnet", "molecule", "multi")], out,
                            workers=2, device=CPU)
    assert failures == []
    with open(out) as f:
        rows = [json.loads(line) for line in f]
    assert sorted((r["arch"], r["multi_pod"]) for r in rows) == \
        [("fm", False), ("schnet", True)]
    for r in rows:
        assert r["status"] == "ok" and r["t_collective_s"] is None
        assert r["bottleneck"] in ("compute", "memory")
        assert r["card"] == "H100"
    # a cell that fails leaves an error row and the next one still runs
    assert not dryrun.run_cells([("fm", "no_such_shape", "single"),
                                 ("fm", "serve_p99", "multi")], out,
                                device=CPU)
    with open(out) as f:
        rows = [json.loads(line) for line in f][2:]
    assert [r["status"][:5] for r in rows] == ["error", "ok"]


def test_production_mesh_shapes():
    single = make_production_mesh(device="meta")
    multi = make_production_mesh(multi_pod=True, device="meta")
    assert single.shape == {"data": 16, "model": 16}
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert rules_for_mesh(single) is SINGLE_POD_RULES
    assert rules_for_mesh(multi) is MULTI_POD_RULES
    assert os.path.basename(os.path.normpath(dryrun.RESULTS_DIR)) == "dryrun"


def test_dpr_like_population_is_make_dpr_like_kbs():
    """The population the launch KB is drawn from is the one
    ``make_dpr_like_kb`` draws its corpus from (its first draws), and
    on-device draws of it have the corpus's statistics."""
    from repro_torch.data import (dpr_like_population, draw_dpr_like_docs,
                                  draw_dpr_like_queries, make_dpr_like_kb)

    kb = make_dpr_like_kb(n_queries=500, n_docs=4000, seed=3, device=CPU)
    pop = dpr_like_population(3, device=CPU)
    g = torch.Generator().manual_seed(0)
    docs = draw_dpr_like_docs(pop, 4000, g)
    queries = draw_dpr_like_queries(pop, 500, g)
    assert docs.shape == (4000, 768) and queries.shape == (500, 768)
    # the doc mean is the population's, in both
    for x in (kb.docs, docs):
        assert float(torch.linalg.vector_norm(x.mean(0) - pop.mu_docs)) < 0.5
    np.testing.assert_allclose(float(docs.norm(dim=1).mean()),
                               kb.meta["doc_l2"], rtol=0.02)
    np.testing.assert_allclose(float(queries.norm(dim=1).mean()),
                               kb.meta["query_l2"], rtol=0.1)
