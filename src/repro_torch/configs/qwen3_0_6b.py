"""qwen3-0.6b [dense] — 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936, per-head qk RMS-norm, tied embeddings.  [hf:Qwen/Qwen3; hf].
The same numbers as ``repro.configs.qwen3_0_6b``."""
from repro_torch.models.lm.transformer import LMConfig

FULL = LMConfig(
    name="qwen3-0.6b", n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
    head_dim=128, d_ff=3072, vocab=151936, act="silu", qk_norm=True,
    tied_embeddings=True, rope_theta=1_000_000.0,
    param_dtype="bfloat16", act_dtype="bfloat16", q_chunk=1024, kv_chunk=1024,
)


def reduced() -> LMConfig:
    return LMConfig(
        name="qwen3-reduced", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=512, act="silu", qk_norm=True,
        tied_embeddings=True, q_chunk=16, kv_chunk=16)
