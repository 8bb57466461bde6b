"""Stage 1 of the exact top-k on its ring path (32 < k ≤ 128, ``block_d``
≤ 4,096: persistent CTAs, a bulk-copy ring, the k survivors chosen
before a one-warp sort), against its plain version.

On the card (``-m chip``; this file imports no JAX, so it runs there),
``topk_blocks`` gives ``topk_blocks_ref``'s value bits and int32 columns
at k ∈ {33, 64, 100, 128} and ``default_block_d(k)`` on Gaussian scores,
few-valued scores (0.25 × an integer in [−60, 60], as the flat 1-bit
cell's), ±0.0 mixed, rows with fewer than k entries above −inf, a ragged
last block (2,848 columns at 4,096), rows that do not start 16 bytes
apart (D % 4 ≠ 0: the per-element loads), a walk of 32 blocks (a
131,072-document chunk of ``topk_search``) and enough rows that every
CTA walks several tiles.  The counters: one launch a call, no tile on
the tie path on Gaussian scores, and at least k survivors at the bound
a tile on the ring path; the k ≤ 32 and k > 128 paths add none.  On the
CPU the cases themselves are checked: each has the shape it claims.
"""

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch import tracing  # noqa: E402
from repro_torch.kernels.topk_blocks.kernel import topk_blocks  # noqa: E402
from repro_torch.kernels.topk_blocks.ops import default_block_d  # noqa: E402
from repro_torch.kernels.topk_blocks.ref import topk_blocks_ref  # noqa: E402
from repro_torch.utils import cdiv  # noqa: E402

KS = (33, 64, 100, 128)
LABELS = ("gaussian", "few", "zeros", "sparse", "ragged", "unaligned",
          "walk32", "many_tiles")
#: CTAs the ring path keeps resident on an H100 (132 SMs, 4 an SM): the
#: "many_tiles" case gives each several tiles
RING_CTAS = 132 * 4


def case_shape(label: str, k: int) -> tuple[int, int]:
    """(rows, columns) of a case at k."""
    bd = default_block_d(k)
    return {"gaussian": (16, 8 * bd), "few": (16, 8 * bd),
            "zeros": (16, 8 * bd), "sparse": (16, 8 * bd),
            "ragged": (16, 8 * bd + (2848 if bd == 4096 else 800)),
            "unaligned": (16, 8 * bd + 1001),
            "walk32": (3, 131_072),
            "many_tiles": (96, 20 * bd + 2848 % bd)}[label]


def case_scores(label: str, k: int, gen, device) -> torch.Tensor:
    rows, cols = case_shape(label, k)
    u = torch.rand(rows, cols, generator=gen, device=device)
    if label == "few":
        return 0.25 * torch.randint(-60, 61, (rows, cols), generator=gen,
                                    device=device).float()
    if label == "zeros":
        s = torch.where(u < 0.5, -0.0, 0.0)
        s.masked_fill_(u > 0.9, float("-inf"))
        return s.masked_fill_(u < 0.005, 1.0)
    s = torch.randn(rows, cols, generator=gen, device=device)
    if label == "sparse":
        # about k/4 entries above −inf a block; the last row none at all
        s.masked_fill_(u >= k / (4 * default_block_d(k)), float("-inf"))
        s[-1] = float("-inf")
    return s


@pytest.mark.parametrize("label", LABELS)
def test_cases_have_the_shapes_they_claim(label):
    for k in KS:
        bd = default_block_d(k)
        assert 32 < k <= 128 and bd <= 4096
        rows, cols = case_shape(label, k)
        n_blocks = cdiv(cols, bd)
        if label == "ragged" and bd == 4096:
            assert cols % bd == 2848
        if label == "unaligned":
            assert cols % 4 != 0
        if label == "walk32" and bd == 4096:
            assert n_blocks == 32
        if label == "many_tiles":
            assert rows * n_blocks >= 3 * RING_CTAS
        s = case_scores(label, k, torch.Generator().manual_seed(k), "cpu")
        assert s.shape == (rows, cols) and s.dtype == torch.float32
        live = (s > float("-inf")).sum(1)
        if label == "sparse":
            assert int(live[-1]) == 0 and int(live.min()) < k


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return "cuda:0"


def assert_plain(vals, idx, scores, k, bd, what):
    """``topk_blocks``' output against ``topk_blocks_ref``'s: the columns
    equal, the values equal (±0.0 as equals), and each value's bits its
    column's own, −inf past the live entries.  The plain version takes
    each value from a max-reduction, whose sign of a ±0.0 follows the
    reduction's order; every other value's bits are its column's there
    too, so elsewhere this is bit equality with the plain version."""
    s = scores.cpu()
    got_v, got_i = vals.cpu(), idx.cpu()
    want_v, want_i = topk_blocks_ref(s, k, bd)
    assert torch.equal(got_i, want_i), what
    assert torch.equal(got_v, want_v), what
    raw = torch.gather(s, 1, got_i.long().clamp(max=s.shape[1] - 1))
    raw = torch.where(want_v == float("-inf"), want_v, raw)
    assert torch.equal(got_v.view(torch.int32), raw.view(torch.int32)), what
    nonzero = want_v != 0
    assert torch.equal(got_v.view(torch.int32)[nonzero],
                       want_v.view(torch.int32)[nonzero]), what


def _counts():
    c = tracing.counters()
    return {n: c.get(n, 0) for n in (
        "topk_blocks.launches", "topk_blocks.tiles", "topk_blocks.tie_tiles",
        "topk_blocks.bound_survivors")}


@pytest.mark.chip
@pytest.mark.parametrize("label", LABELS)
@pytest.mark.parametrize("k", KS)
def test_ring_path_equals_the_plain_version(k, label, card):
    bd = default_block_d(k)
    gen = torch.Generator(device=card).manual_seed(29_000 + k)
    scores = case_scores(label, k, gen, card)
    before = _counts()
    vals, idx = topk_blocks(scores, k, bd)
    torch.cuda.synchronize()
    after = _counts()
    assert_plain(vals, idx, scores, k, bd, label)
    d = {n: after[n] - before[n] for n in after}
    rows, cols = scores.shape
    assert d["topk_blocks.launches"] == 1
    assert d["topk_blocks.tiles"] == rows * cdiv(cols, bd)
    ring = d["topk_blocks.tiles"] - d["topk_blocks.tie_tiles"]
    if label in ("gaussian", "ragged", "unaligned", "walk32", "many_tiles"):
        assert d["topk_blocks.tie_tiles"] == 0, d
        assert d["topk_blocks.bound_survivors"] >= k * ring, d


@pytest.mark.chip
@pytest.mark.parametrize("k", [10, 1010])
def test_other_depths_keep_their_kernels(k, card):
    """k ≤ 32 (the warp kernel) and k > 128 (the per-block CTA kernel) do
    not take the ring path: no survivors counted, the same bits."""
    bd = default_block_d(k)
    gen = torch.Generator(device=card).manual_seed(29_001)
    scores = torch.randn(8, 3 * bd + 1000, generator=gen, device=card)
    before = _counts()
    vals, idx = topk_blocks(scores, k, bd)
    torch.cuda.synchronize()
    after = _counts()
    assert_plain(vals, idx, scores, k, bd, k)
    assert after["topk_blocks.bound_survivors"] == \
        before["topk_blocks.bound_survivors"]
    assert after["topk_blocks.launches"] - before["topk_blocks.launches"] == 1
