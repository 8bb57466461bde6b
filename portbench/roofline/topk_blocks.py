"""``topk_blocks`` (``csrc/topk_blocks.cu``): each block of ``block_d``
columns of a (Q, N) f32 score matrix reduced to its top k (value, index).

It reads the scores once and writes Q·ceil(N/block_d)·k pairs of 4-byte
values and indices; Q·N comparisons at the f32 rate.  ``block_d`` is the
program's rule for the block at depth k, frozen here:
``max(1024, next_pow2(k), min(32768, next_pow2(32·k)))``."""


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def block_d(k: int) -> int:
    return max(1024, _next_pow2(k), min(32768, _next_pow2(32 * k)))


def work(q: int, n_docs: int, k: int) -> tuple[float, float, str]:
    n_blocks = -(-n_docs // block_d(k))
    return float(q * n_docs * 4 + q * n_blocks * k * 8), float(q * n_docs), \
        "f32"
