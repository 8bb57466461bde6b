"""phi4-mini-3.8b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064; RoPE SwiGLU GQA.  [arXiv:2412.08905; hf]"""

from repro_torch.configs.base import ArchConfig, LMConfig, LM_SHAPES

FULL = LMConfig(
    name="phi4-mini-3.8b", n_layers=32, d_model=3072, n_heads=24,
    n_kv_heads=8, d_ff=8192, vocab_size=200064, ffn="swiglu",
    parallel_mode="fsdp")

REDUCED = LMConfig(
    name="phi4-mini-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512, ffn="swiglu", attn_q_chunk=16)

ARCH = ArchConfig(name="phi4-mini-3.8b", family="lm", model=FULL,
                  shapes=LM_SHAPES, reduced=REDUCED)
