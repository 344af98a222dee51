"""deepseek-67b [dense] — 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400, llama-style arch.  [arXiv:2401.02954; hf].
The same numbers as ``repro.configs.deepseek_67b``."""
from repro_torch.models.lm.transformer import LMConfig

FULL = LMConfig(
    name="deepseek-67b", n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    head_dim=128, d_ff=22016, vocab=102400, act="silu",
    param_dtype="bfloat16", act_dtype="bfloat16", q_chunk=1024, kv_chunk=1024,
)


def reduced() -> LMConfig:
    return LMConfig(
        name="deepseek-reduced", n_layers=5, d_model=64, n_heads=8,
        n_kv_heads=2, head_dim=8, d_ff=160, vocab=512, act="silu",
        q_chunk=16, kv_chunk=16)
