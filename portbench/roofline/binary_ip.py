"""``binary_ip`` (``csrc/binary_ip.cu``): ±1 int8 query signs × packed
1-bit document words on the tensor cores, writing the (Q, N) f32 scores
0.25·sign dot.

A search call of Q queries over N documents of W words needs the int8
query signs (32·W bytes a query), the words and the score matrix written
once; 2·Q·N·32W operations at the int8 rate (the signs and the bits meet
as s8 × s8 products)."""


def work(q: int, n_docs: int, words: int) -> tuple[float, float, str]:
    n_bytes = q * 32 * words + n_docs * 4 * words + q * n_docs * 4
    return float(n_bytes), 2.0 * q * n_docs * 32 * words, "int8"
