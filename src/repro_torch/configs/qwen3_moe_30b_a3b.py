"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128 experts top-8 (fine-grained).  [hf:Qwen/Qwen3-30B-A3B]"""

from repro_torch.configs.base import ArchConfig, LMConfig, LM_SHAPES, MoEConfig

FULL = LMConfig(
    name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
    n_kv_heads=4, d_ff=768, vocab_size=151936, ffn="swiglu",
    head_dim=128,
    moe=MoEConfig(n_experts=128, top_k=8), train_microbatches=8)

REDUCED = LMConfig(
    name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=32, vocab_size=512, ffn="swiglu", head_dim=16, attn_q_chunk=16,
    moe=MoEConfig(n_experts=8, top_k=2))

ARCH = ArchConfig(name="qwen3-moe-30b-a3b", family="lm", model=FULL,
                  shapes=LM_SHAPES, reduced=REDUCED)
