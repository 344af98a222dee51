"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2.  [hf:xai-org/grok-1; unverified].
The same numbers as ``repro.configs.grok_1_314b``."""
from repro_torch.models.lm.transformer import LMConfig

FULL = LMConfig(
    name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    head_dim=128, d_ff=32768, vocab=131072, act="gelu",
    n_experts=8, top_k=2, moe_layer_period=1, capacity_factor=1.25,
    param_dtype="bfloat16", act_dtype="bfloat16", q_chunk=1024, kv_chunk=1024,
)


def reduced() -> LMConfig:
    return LMConfig(
        name="grok-1-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=256, vocab=512, act="gelu", n_experts=4, top_k=2,
        moe_layer_period=1, q_chunk=16, kv_chunk=16)
