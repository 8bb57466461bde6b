"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4, fine-grained.  [hf:databricks/dbrx-base; unverified]"""

from repro_torch.configs.base import ArchConfig, LMConfig, LM_SHAPES, MoEConfig

FULL = LMConfig(
    name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab_size=100352, ffn="swiglu",
    moe=MoEConfig(n_experts=16, top_k=4), train_microbatches=8)

REDUCED = LMConfig(
    name="dbrx-132b-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=96, vocab_size=512, ffn="swiglu", attn_q_chunk=16,
    moe=MoEConfig(n_experts=4, top_k=2))

ARCH = ArchConfig(name="dbrx-132b", family="lm", model=FULL,
                  shapes=LM_SHAPES, reduced=REDUCED)
