"""nemotron-4-340b [dense] — 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000; squared-ReLU FFN.  [arXiv:2402.16819; unverified]"""

from repro_torch.configs.base import ArchConfig, LMConfig, LM_SHAPES

FULL = LMConfig(
    name="nemotron-4-340b", n_layers=96, d_model=18432, n_heads=96,
    n_kv_heads=8, d_ff=73728, vocab_size=256000, ffn="squared_relu",
    train_microbatches=8)

REDUCED = LMConfig(
    name="nemotron-smoke", n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=256, vocab_size=512, ffn="squared_relu", attn_q_chunk=16)

ARCH = ArchConfig(name="nemotron-4-340b", family="lm", model=FULL,
                  shapes=LM_SHAPES, reduced=REDUCED)
