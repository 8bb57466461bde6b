"""The port's configs and batch synthesis against ``repro``'s.

Configs equal field for field (every arch, FULL and REDUCED, and its
shapes), with the same registry names.  ``make_batch`` gives byte-equal
batches for all 42 arch × shape cells (``tests/test_configs_smoke.py``'s
list), reduced, from the same numpy seed; ``input_specs`` gives the same
shapes and dtypes, reduced and at production dims.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs import registry as r_reg  # noqa: E402
from repro.data import batches as r_batches  # noqa: E402
from repro_torch.configs import registry as p_reg  # noqa: E402
from repro_torch.data import batches as p_batches  # noqa: E402
from repro_torch.train.optimizer import (tree_num_params,  # noqa: E402
                                         tree_size_bytes)
from repro_torch.utils import round_up  # noqa: E402

CELLS = [(a, s.name) for a in r_reg.ALL_NAMES
         for s in r_reg.get_arch(a).shapes]


def _fields(x):
    """A config as nested plain data (dataclasses by field, type named)."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,
                {f.name: _fields(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return [_fields(v) for v in x]
    if isinstance(x, dict):
        return {k: _fields(v) for k, v in x.items()}
    return x


def test_registry_names_equal():
    assert p_reg.ALL_NAMES == r_reg.ALL_NAMES
    assert p_reg.ARCH_NAMES == r_reg.ARCH_NAMES
    assert len(CELLS) == 42
    with pytest.raises(KeyError):
        p_reg.get_arch("no-such-arch")


@pytest.mark.parametrize("name", r_reg.ALL_NAMES)
def test_arch_config_equal_field_for_field(name):
    got, want = p_reg.get_arch(name), r_reg.get_arch(name)
    assert _fields(got) == _fields(want)
    assert type(got).__module__.startswith("repro_torch.")


def test_lm_param_counts_equal():
    for name in r_reg.ARCH_NAMES:
        got, want = p_reg.get_arch(name), r_reg.get_arch(name)
        if want.family == "lm":
            assert got.model.params_dense() == want.model.params_dense()
            assert got.model.params_active() == want.model.params_active()
            assert got.model.resolved_head_dim == want.model.resolved_head_dim


@pytest.mark.parametrize("arch_name,shape_name", CELLS,
                         ids=[f"{a}:{s}" for a, s in CELLS])
def test_make_batch_byte_equal(arch_name, shape_name):
    r_arch, p_arch = r_reg.get_arch(arch_name), p_reg.get_arch(arch_name)
    want = r_batches.make_batch(np.random.default_rng(42), r_arch,
                                r_arch.shape(shape_name), reduced=True)
    got = p_batches.make_batch(np.random.default_rng(42), p_arch,
                               p_arch.shape(shape_name), reduced=True,
                               device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k
    specs = p_batches.input_specs(p_arch, p_arch.shape(shape_name),
                                  reduced=True)
    for k, s in specs.items():
        assert s.is_meta and got[k].shape == s.shape
        assert got[k].dtype == s.dtype


@pytest.mark.parametrize("arch_name", r_reg.ALL_NAMES)
def test_full_input_specs_equal(arch_name):
    r_arch, p_arch = r_reg.get_arch(arch_name), p_reg.get_arch(arch_name)
    for shape in r_arch.shapes:
        want = r_batches.input_specs(r_arch, shape, reduced=False)
        got = p_batches.input_specs(p_arch, p_arch.shape(shape.name),
                                    reduced=False)
        assert sorted(got) == sorted(want)
        for k, s in want.items():
            assert tuple(got[k].shape) == tuple(s.shape), (shape.name, k)
            assert str(got[k].dtype).split(".")[-1] == str(s.dtype), k
        assert (p_batches.shape_dims(p_arch.shape(shape.name), False)
                == r_batches.shape_dims(shape, False))
        assert (p_batches.reduce_dims(p_arch.shape(shape.name))
                == r_batches.reduce_dims(shape))


def test_fix_edges_equal():
    r_arch, p_arch = r_reg.get_arch("schnet"), p_reg.get_arch("schnet")
    shape = "full_graph_sm"
    want = r_batches.fix_edges(
        r_batches.make_batch(np.random.default_rng(3), r_arch,
                             r_arch.shape(shape)), 100,
        np.random.default_rng(7))
    got = p_batches.fix_edges(
        p_batches.make_batch(np.random.default_rng(3), p_arch,
                             p_arch.shape(shape), device="cpu"), 100,
        np.random.default_rng(7))
    np.testing.assert_array_equal(got["edge_index"].numpy(),
                                  np.asarray(want["edge_index"]))
    assert int(got["edge_index"].max()) < 100


def test_make_batch_default_device_is_cuda():
    arch = p_reg.get_arch("fm")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        p_batches.make_batch(np.random.default_rng(0), arch,
                             arch.shape("serve_p99"))


def test_utils_round_up_and_tree_sizes():
    from repro.utils import round_up as r_round_up
    for a, b in ((0, 512), (1, 512), (512, 512), (10556, 512), (7, 3)):
        assert round_up(a, b) == r_round_up(a, b)
    tree = {"a": torch.zeros(3, 4),
            "b": [torch.zeros(5, dtype=torch.int8),
                  (torch.zeros(2, dtype=torch.int32),)],
            "c": torch.empty(6, 2, device="meta")}
    assert tree_num_params(tree) == 12 + 5 + 2 + 12
    assert tree_size_bytes(tree) == 48 + 5 + 8 + 48
