"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1, interleaved MoE every other
layer (HF Llama-4 interleave_moe_layer_step=2).  [hf:meta-llama/Llama-4;
unverified].  Early-fusion multimodal frontend is a stub — the backbone
consumes token ids (DESIGN.md §5).
The same numbers as ``repro.configs.llama4_maverick_400b_a17b``."""
from repro_torch.models.lm.transformer import LMConfig

FULL = LMConfig(
    name="llama4-maverick-400b-a17b", n_layers=48, d_model=5120, n_heads=40,
    n_kv_heads=8, head_dim=128, d_ff=8192, vocab=202048, act="silu",
    n_experts=128, top_k=1, moe_layer_period=2, capacity_factor=1.25,
    param_dtype="bfloat16", act_dtype="bfloat16", q_chunk=1024, kv_chunk=1024,
)


def reduced() -> LMConfig:
    return LMConfig(
        name="llama4-maverick-reduced", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, act="silu",
        n_experts=8, top_k=1, moe_layer_period=2, q_chunk=16, kv_chunk=16)
