"""``int8_ip`` (``csrc/int8_ip.cu``): bf16(q⊙scale) × uint8 codes on the
tensor cores, plus a per-query f32 bias, writing the (Q, N) f32 scores.

A search call of Q queries over N documents of d codes needs the bf16
queries, the codes, the bias once and the score matrix written once;
2·Q·N·d operations at the bf16 rate."""


def work(q: int, n_docs: int, d: int) -> tuple[float, float, str]:
    n_bytes = q * d * 2 + n_docs * d + q * 4 + q * n_docs * 4
    return float(n_bytes), 2.0 * q * n_docs * d, "bf16"
