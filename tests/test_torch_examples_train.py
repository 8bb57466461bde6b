"""The port's training examples (``examples_torch/``) against ``repro``'s.

Both packages' examples run in this process on the CPU, loaded by path
(no file under ``examples/`` changes); ``repro``'s printed lines are
captured.

* The data: ``make_world``, ``feature_ids``, the first
  ``synthetic_interactions`` batch and ``zipf_corpus`` byte-equal.
* train_retriever: the param count equal; ``repro``'s example trains 50
  steps into a checkpoint directory, then ``repro``'s and the port's each
  ``--resume`` from it (the port reads ``repro``'s checkpoint): from
  equal parameters their cluster-precision@10, exact and compressed,
  agree within 0.02, with the same compression ratio.
* knn_lm at 5 steps: the datastore's shape and the compression ratio
  equal, both perplexities finite.
"""

import math
import re
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from examples_loader import load_example  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.models import layers as r_layers  # noqa: E402
from repro.models import recsys as r_recsys  # noqa: E402
from repro_torch.models import layers as p_layers  # noqa: E402
from repro_torch.models import recsys as p_recsys  # noqa: E402

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def retriever():
    return (load_example("examples", "train_retriever"),
            load_example("examples_torch", "train_retriever"))


@pytest.fixture(scope="module")
def knn():
    return (load_example("examples", "knn_lm"),
            load_example("examples_torch", "knn_lm"))


def repro_main(mod, argv, capsys) -> list[str]:
    """``repro``'s example ``main``, with the SIGTERM handler it installs
    (``PreemptionHandler``, never uninstalled there) put back after."""
    prev = signal.getsignal(signal.SIGTERM)
    try:
        mod.main(argv)
    finally:
        signal.signal(signal.SIGTERM, prev)
    return capsys.readouterr().out.splitlines()


def number_after(lines, label: str) -> float:
    for ln in lines:
        m = re.search(re.escape(label) + r"\s*([-0-9.]+)", ln)
        if m:
            return float(m.group(1))
    raise AssertionError(f"no {label!r} in {lines}")


def test_world_and_stream_byte_equal(retriever):
    r_mod, p_mod = retriever
    r_rng, p_rng = np.random.default_rng(0), np.random.default_rng(0)
    r_world, p_world = r_mod.make_world(r_rng), p_mod.make_world(p_rng)
    for r, p in zip(r_world, p_world):
        assert p.tobytes() == r.tobytes() and p.dtype == r.dtype
    cfg = p_mod.SIZES["small"]
    ents = np.arange(0, 20_000, 7)
    assert (p_mod.feature_ids(ents, p_world[1], 4, cfg.item_vocab).tobytes()
            == r_mod.feature_ids(ents, r_world[1], 4,
                                 cfg.item_vocab).tobytes())
    r_batch, r_users, r_items = next(r_mod.synthetic_interactions(
        r_rng, r_mod.SIZES["small"], 64, *r_world))
    p_batch, p_users, p_items = next(p_mod.synthetic_interactions(
        p_rng, cfg, 64, *p_world, torch.device("cpu")))
    assert p_users.tobytes() == r_users.tobytes()
    assert p_items.tobytes() == r_items.tobytes()
    for key in ("user_ids", "item_ids"):
        assert p_batch[key].dtype == torch.int32
        assert (p_batch[key].numpy().tobytes()
                == np.asarray(r_batch[key]).tobytes())
    assert p_rng.bit_generator.state == r_rng.bit_generator.state


def test_zipf_corpus_byte_equal(knn):
    r_mod, p_mod = knn
    assert p_mod.CFG == p_mod.CFG.__class__(**{
        f: getattr(r_mod.CFG, f) for f in p_mod.CFG.__dataclass_fields__})
    toks = []
    for mod, extra in ((r_mod, ()), (p_mod, (torch.device("cpu"),))):
        rng = np.random.default_rng(0)
        trans = rng.integers(0, 256, (256, 4))
        toks.append([np.asarray(mod.zipf_corpus(rng, n, 64, 256, trans,
                                                *extra))
                     for n in (256, 32)])
    for r, p in zip(*toks):
        assert p.dtype == r.dtype == np.int32 and p.tobytes() == r.tobytes()


def test_train_retriever_resumes_from_repro_checkpoint(retriever, tmp_path,
                                                       capsys):
    r_mod, p_mod = retriever
    ckpt = ["--steps", "50", "--ckpt-dir", str(tmp_path)]
    trained = repro_main(r_mod, ckpt, capsys)
    assert any(ln.startswith("step 50: loss=") for ln in trained)
    r_lines = repro_main(r_mod, ckpt + ["--resume"], capsys)
    out = p_mod.run(ckpt + ["--resume"] + CPU)
    p_lines = capsys.readouterr().out.splitlines()

    cfg = r_mod.SIZES["small"]
    n_params = r_layers.param_count(r_recsys.two_tower_spec(cfg))
    assert out["n_params"] == n_params == p_layers.param_count(
        p_recsys.two_tower_spec(p_mod.SIZES["small"]))
    assert p_lines[0] == r_lines[0] == f"model: {n_params / 1e6:.1f}M params"
    assert "resumed from step 50" in r_lines
    assert "resumed from step 50" in p_lines
    assert out["resumed_from"] == 50 and out["steps_trained"] == 0
    r_exact = number_after(r_lines, "uncompressed cluster-precision@10:")
    r_comp = number_after(r_lines, "compressed  cluster-precision@10:")
    assert abs(out["exact_p10"] - r_exact) <= 0.02, (out, r_exact)
    assert abs(out["compressed_p10"] - r_comp) <= 0.02, (out, r_comp)
    assert f"at {out['ratio']:.0f}x smaller" in [
        ln for ln in r_lines if "compressed  " in ln][0]


def test_knn_lm_matches_repro(knn, capsys):
    r_mod, p_mod = knn
    r_lines = repro_main(r_mod, ["--steps", "5"], capsys)
    out = p_mod.run(["--steps", "5"] + CPU)
    p_lines = capsys.readouterr().out.splitlines()
    for needle in ("datastore:", "compressed "):
        want = [ln for ln in r_lines if ln.startswith(needle)]
        assert want and [ln for ln in p_lines
                         if ln.startswith(needle)] == want
    assert out["datastore"] == (256 * 63, 64)
    for label in ("perplexity LM-only:", "perplexity kNN-LM (24x index):"):
        assert math.isfinite(number_after(r_lines, label))
    assert math.isfinite(out["ppl_lm"]) and math.isfinite(out["ppl_knn"])
