"""The fused IVF top-k: the port's plain version against ``repro``'s kernel.

The same seeded numpy inputs (list-major storage with −1 pads and an
all-pad list, distinct probes per query, float queries) go through
``repro``'s ``fused_ivf_topk(use_pallas=True)`` — the Pallas kernel in
interpret mode, as ``tests/test_ivf_fused.py`` runs it — and through the
port's ``ops.fused_ivf_topk`` on CPU tensors, which runs the plain version
the CUDA kernel is held against on the card.

The plain mirror of the card's list-major stages (``list_major_topk_ref``:
invert the probe table, score each list once for its (query, slot) pairs
and keep each pair's top-min(k, L), merge per query) is held to both, on
lists probed by every query, a query probing one list twice, heavy score
ties, pad ids, a residual base, k > L and k > ``MAX_K``.

Bars: 1-bit scores are 0.25 × integer sign dots, so ids and score bits
are equal.  float, fp16 and int8 use the same numerics on both sides
(int8 as bf16 q⊙scale × u8, each product exact in f32), so only the order
of the f32 sums differs: values within 1e-5·max|v|, and ids equal at
every rank whose neighbouring values differ by more than that.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.kernels.ivf_fused import ops as r_ops  # noqa: E402
from repro_torch.core.quantization import words_from_numpy  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.ivf_fused import ops as p_ops  # noqa: E402
from repro_torch.kernels.ivf_fused.kernel import (MAX_K,  # noqa: E402
                                                  fused_ivf_topk)
from repro_torch.kernels.ivf_fused.ref import (  # noqa: E402
    BACKENDS, fused_ivf_topk_ref, list_major_topk_ref)

NLIST, L, DIM, Q = 24, 40, 48, 12


def _case(backend, nprobe, with_base, seed=0, length=L):
    """Seeded list-major inputs: numpy for repro, tensors for the port."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(NLIST * length).astype(np.int32) \
        .reshape(NLIST, length)
    ids[rng.random((NLIST, length)) < 0.2] = -1     # ragged lists
    ids[3] = -1                                      # an all-pad list
    ids = np.sort(np.where(ids < 0, NLIST * length, ids), axis=1)
    ids[ids == NLIST * length] = -1                  # pads at the tail
    q = rng.standard_normal((Q, DIM)).astype(np.float32)
    params = {}
    if backend == "float":
        store = rng.standard_normal((NLIST, length, DIM)).astype(np.float32)
    elif backend == "fp16":
        store = rng.standard_normal((NLIST, length, DIM)).astype(np.float16)
    elif backend == "int8":
        store = rng.integers(0, 256, (NLIST, length, DIM)).astype(np.uint8)
        params = {"scale": rng.uniform(0.001, 0.02, DIM).astype(np.float32),
                  "zero": rng.uniform(-1, 0, DIM).astype(np.float32)}
    else:   # 45 dims → 2 words: the query signs are padded with −1
        q = q[:, :45]
        store = rng.integers(0, 2**32, (NLIST, length, 2),
                             dtype=np.uint64).astype(np.uint32)
    store[ids < 0] = 0
    probes = np.stack([rng.permutation(NLIST)[:nprobe]
                       for _ in range(Q)]).astype(np.int32)
    extra = (rng.standard_normal((Q, nprobe)).astype(np.float32)
             if with_base else None)
    return q, store, ids, probes, params, extra


#: k above the card's shared-memory top-k, held against repro's kernel
K_ABOVE = 1100
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
#: repro's interpret-mode kernel at k = K_ABOVE on the inputs in argv[1]
_REPRO_K_ABOVE = """
import sys
import jax.numpy as jnp
import numpy as np
from repro.kernels.ivf_fused import ops
d = np.load(sys.argv[1])
v, i = ops.fused_ivf_topk(
    jnp.asarray(d["probes"]), jnp.asarray(d["q"]), jnp.asarray(d["store"]),
    jnp.asarray(d["ids"]), int(sys.argv[3]), "int8",
    params={"scale": jnp.asarray(d["scale"]), "zero": jnp.asarray(d["zero"])},
    extra_base=jnp.asarray(d["extra"]), use_pallas=True)
np.savez(sys.argv[2], v=np.asarray(v), i=np.asarray(i))
"""


def _k1100_case():
    """int8, 2 probes of 800-row lists, the queries that skip the all-pad
    list."""
    q, store, ids, probes, params, extra = _case("int8", 2, True, seed=5,
                                                 length=800)
    keep = (probes != 3).all(axis=1)[:3]
    return (q[:3][keep], store, ids, probes[:3][keep], params,
            extra[:3][keep])


@pytest.fixture(scope="module", autouse=True)
def repro_k1100(tmp_path_factory):
    """``repro``'s kernel at k = K_ABOVE in a subprocess started with the
    module, so its compile overlaps the module's other tests; killed at
    teardown if a selection never waited for it."""
    d = tmp_path_factory.mktemp("k_above")
    q, store, ids, probes, params, extra = _k1100_case()
    np.savez(d / "in.npz", q=q, store=store, ids=ids, probes=probes,
             extra=extra, **params)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REPRO_K_ABOVE, str(d / "in.npz"),
         str(d / "out.npz"), str(K_ABOVE)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield proc, d / "out.npz"
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


def _port_inputs(q, store, ids, probes, params, extra):
    to = torch.from_numpy
    store_t = words_from_numpy(store) if store.dtype == np.uint32 \
        else to(store)
    return (to(probes), to(q), store_t, to(ids),
            {k: to(v) for k, v in params.items()},
            to(extra) if extra is not None else None)


def _repro(backend, k, q, store, ids, probes, params, extra):
    v, i = r_ops.fused_ivf_topk(
        jnp.asarray(probes), jnp.asarray(q), jnp.asarray(store),
        jnp.asarray(ids), k, backend,
        params={n: jnp.asarray(a) for n, a in params.items()},
        extra_base=None if extra is None else jnp.asarray(extra),
        use_pallas=True)
    return np.asarray(v), np.asarray(i)


def _mirror_inputs(backend, q, store, ids, probes, params, extra):
    """The kernel wrapper's arguments, prepared as ``ops.fused_ivf_topk``
    prepares them."""
    probes_t, q_t, store_t, ids_t, params_t, extra_t = _port_inputs(
        q, store, ids, probes, params, extra)
    qe, base_q = p_ops.prepare_queries(
        q_t, backend, params_t,
        packed_width=store_t.shape[-1] if backend == "onebit" else None)
    base = base_q[:, None].expand(probes_t.shape).float()
    if extra_t is not None:
        base = base + extra_t
    return probes_t, qe, store_t, ids_t, base


def _mirror(backend, k, *case):
    v, i = list_major_topk_ref(*_mirror_inputs(backend, *case), k, backend)
    return v.numpy(), i.numpy()


def _list_major_case(backend, kind, seed=7):
    """Every query probes every list (each list probed by all Q queries);
    ``twice``: some queries probe one list in two slots; ``ties``: small
    integer rows and queries, so scores tie heavily."""
    q, store, ids, probes, params, extra = _case(backend, NLIST, True,
                                                 seed=seed)
    if kind == "twice":
        probes[::2, 1] = probes[::2, 0]
    elif kind == "ties":
        rng = np.random.default_rng(seed)
        q = rng.integers(-1, 2, q.shape).astype(np.float32)
        if backend in ("float", "fp16"):
            store = rng.integers(-1, 2, store.shape).astype(store.dtype)
        elif backend == "int8":
            store = rng.integers(0, 3, store.shape).astype(np.uint8)
        store[ids < 0] = 0
        extra = np.round(extra)
    return q, store, ids, probes, params, extra


@pytest.mark.parametrize("kind", ["all_queries", "twice", "ties"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_list_major_mirror_matches_repro_pallas(backend, kind):
    """The list-major mirror ranks as ``repro``'s interpret-mode kernel
    at k = 10 (each pair keeps its top-10 of a 40-row list)."""
    case = _list_major_case(backend, kind)
    want = _repro(backend, 10, *case)
    got = _mirror(backend, 10, *case)
    assert_same_ranking(got, want, exact=backend == "onebit")
    assert_same_ranking(got, _port(backend, 10, *case), exact=True)


@pytest.mark.parametrize("k", [3, 39, 40, 41, 100, MAX_K + 1, 2500])
@pytest.mark.parametrize("kind", ["all_queries", "twice", "ties"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_list_major_mirror_matches_the_slot_fold(backend, kind, k):
    """Bit for bit the plain version's slot-by-slot fold, for k below,
    at and above L = 40, above MAX_K and beyond the reachable rows (the
    tail (−inf, −1))."""
    args = _mirror_inputs(backend, *_list_major_case(backend, kind))
    got = list_major_topk_ref(*args, k, backend)
    want = fused_ivf_topk_ref(*args, k, backend)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


def test_list_major_mirror_skips_probes_outside_the_lists():
    """A probe outside [0, nlist) contributes nothing (the kernel skips its
    pairs and its candidates)."""
    case = list(_list_major_case("int8", "all_queries"))
    probes = case[3].copy()
    probes[:, 5] = -1
    probes[:, 6] = NLIST
    args = _mirror_inputs("int8", *case[:3], probes, *case[4:])
    keep = [j for j in range(NLIST) if j not in (5, 6)]
    want = fused_ivf_topk_ref(args[0][:, keep], args[1], args[2], args[3],
                              args[4][:, keep], 30, "int8")
    got = list_major_topk_ref(*args, 30, "int8")
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def _port(backend, k, q, store, ids, probes, params, extra):
    probes_t, q_t, store_t, ids_t, params_t, extra_t = _port_inputs(
        q, store, ids, probes, params, extra)
    v, i = p_ops.fused_ivf_topk(probes_t, q_t, store_t, ids_t, k, backend,
                                params=params_t, extra_base=extra_t)
    return v.numpy(), i.numpy()


def assert_same_ranking(got, want, exact):
    """Exact: ids and value bits equal.  Otherwise values within
    1e-5·max|v| and ids equal wherever the wanted neighbours are apart."""
    (gv, gi), (wv, wi) = got, want
    assert gv.shape == wv.shape and gi.shape == wi.shape
    np.testing.assert_array_equal(np.isfinite(gv), np.isfinite(wv))
    if exact:
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32))
        return
    fin = np.isfinite(wv)
    tol = 1e-5 * np.abs(wv[fin]).max()
    assert np.abs(gv[fin] - wv[fin]).max() <= tol
    np.testing.assert_array_equal(gi[~fin], wi[~fin])
    gap = np.full(wv.shape, np.inf)
    d = np.abs(np.diff(np.where(fin, wv, 0), axis=1))
    gap[:, 1:] = np.minimum(gap[:, 1:], d)
    gap[:, :-1] = np.minimum(gap[:, :-1], d)
    apart = fin & (gap > tol)
    np.testing.assert_array_equal(gi[apart], wi[apart])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("nprobe", [1, 5, 24])
@pytest.mark.parametrize("with_base", [False, True])
def test_plain_version_matches_repro_pallas(backend, nprobe, with_base):
    case = _case(backend, nprobe, with_base)
    assert_same_ranking(_port(backend, 10, *case),
                        _repro(backend, 10, *case),
                        exact=backend == "onebit")


@pytest.mark.parametrize("backend", ["int8", "onebit"])
def test_k_beyond_the_reachable_candidates_pads_the_tail(backend):
    """Two probed lists hold < 100 rows: the tail is (−inf, −1), as
    ``repro`` pads it."""
    case = _case(backend, 2, True, seed=3)
    got = _port(backend, 100, *case)
    assert_same_ranking(got, _repro(backend, 100, *case),
                        exact=backend == "onebit")
    assert (got[1][:, -1] == -1).all() and np.isneginf(got[0][:, -1]).all()


def test_prepare_queries_matches_repro():
    q, _, _, _, params, _ = _case("int8", 1, False)
    qe, base = p_ops.prepare_queries(
        torch.from_numpy(q), "int8",
        {k: torch.from_numpy(v) for k, v in params.items()})
    rqe, rbase = r_ops.prepare_queries(
        jnp.asarray(q), "int8", {k: jnp.asarray(v) for k, v in params.items()})
    np.testing.assert_array_equal(qe.float().numpy(),
                                  np.asarray(rqe.astype(jnp.float32)))
    np.testing.assert_allclose(base.numpy(), np.asarray(rbase), rtol=1e-5,
                               atol=1e-6)
    signs, _ = p_ops.prepare_queries(torch.from_numpy(q[:, :45]), "onebit",
                                     {}, packed_width=2)
    rsigns, _ = r_ops.prepare_queries(jnp.asarray(q[:, :45]), "onebit", {},
                                      packed_width=2)
    np.testing.assert_array_equal(signs.numpy(), np.asarray(rsigns))
    with pytest.raises(ValueError, match="packed_width"):
        p_ops.prepare_queries(torch.from_numpy(q), "onebit", {})


def test_wrapper_checks_and_cpu_launches_do_not_count():
    q, store, ids, probes, params, _ = _case("float", 3, False)
    probes_t, q_t, store_t, ids_t, _, _ = _port_inputs(
        q, store, ids, probes, params, None)
    base = torch.zeros(probes_t.shape)
    before = launch_counts()
    fused_ivf_topk(probes_t, q_t, store_t, ids_t, base, 5, "float")
    fused_ivf_topk(probes_t, q_t, store_t, ids_t, base, MAX_K + 1, "float")
    assert launch_counts() == before
    with pytest.raises(TypeError):
        fused_ivf_topk(probes_t.long(), q_t, store_t, ids_t, base, 5, "float")
    with pytest.raises(TypeError):
        fused_ivf_topk(probes_t, q_t, store_t, ids_t, base, 5, "fp16")
    with pytest.raises(ValueError, match="shapes"):
        fused_ivf_topk(probes_t, q_t[:, :7], store_t, ids_t, base, 5, "float")
    with pytest.raises(ValueError, match="backend"):
        fused_ivf_topk(probes_t, q_t, store_t, ids_t, base, 5, "int4")
    with pytest.raises(ValueError, match="k must"):
        fused_ivf_topk(probes_t, q_t, store_t, ids_t, base, 0, "float")


def test_k_above_the_shared_memory_top_k_matches_repro(repro_k1100):
    """k = 1100 > MAX_K: the card keeps the running top-k in a global
    scratch; the wrapper takes any k, and its plain version ranks as
    ``repro``'s interpret-mode kernel does.  int8, the main path's backend,
    only: ``repro`` unrolls its merge into k rounds, ~3 minutes of tracing
    and compiling at this k whatever the shapes, so ``repro``'s side runs
    in a subprocess started with the module (the last test here)."""
    backend = "int8"
    case = _k1100_case()
    got = _port(backend, K_ABOVE, *case)
    assert got[0].shape == (case[0].shape[0], K_ABOVE) and MAX_K < K_ABOVE
    assert (got[1][:, -1] >= 0).all()        # every slot holds a real row
    proc, out = repro_k1100
    log, _ = proc.communicate(timeout=1200)
    assert proc.returncode == 0, log
    with np.load(out) as res:
        want = res["v"], res["i"]
    assert_same_ranking(got, want, exact=backend == "onebit")
    # the list-major mirror: each pair hands over its whole 800-row list
    assert_same_ranking(_mirror(backend, K_ABOVE, *case), want,
                        exact=backend == "onebit")
