"""gemma-7b [dense] — 28L d_model=3072 16H (kv=16, i.e. MHA) d_ff=24576
vocab=256000, GeGLU, head_dim=256, tied embeddings.  [arXiv:2403.08295; hf].
The same numbers as ``repro.configs.gemma_7b``."""
from repro_torch.models.lm.transformer import LMConfig

FULL = LMConfig(
    name="gemma-7b", n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
    head_dim=256, d_ff=24576, vocab=256000, act="gelu", tied_embeddings=True,
    param_dtype="bfloat16", act_dtype="bfloat16", q_chunk=1024, kv_chunk=1024,
)


def reduced() -> LMConfig:
    return LMConfig(
        name="gemma-7b-reduced", n_layers=3, d_model=48, n_heads=4,
        n_kv_heads=4, head_dim=24, d_ff=96, vocab=512, act="gelu",
        tied_embeddings=True, q_chunk=16, kv_chunk=16)
