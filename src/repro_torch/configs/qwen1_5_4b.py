"""qwen1.5-4b [dense] — 40L d_model=2560 20H (kv=20: full MHA) d_ff=6912
vocab=151936; QKV bias.  [hf:Qwen/Qwen1.5-4B family]"""

from repro_torch.configs.base import ArchConfig, LMConfig, LM_SHAPES

FULL = LMConfig(
    name="qwen1.5-4b", n_layers=40, d_model=2560, n_heads=20,
    n_kv_heads=20, d_ff=6912, vocab_size=151936, ffn="swiglu",
    qkv_bias=True, parallel_mode="fsdp")

REDUCED = LMConfig(
    name="qwen1.5-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, ffn="swiglu", qkv_bias=True, attn_q_chunk=16)

ARCH = ArchConfig(name="qwen1.5-4b", family="lm", model=FULL,
                  shapes=LM_SHAPES, reduced=REDUCED)
