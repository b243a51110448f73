"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H (MLA) d_ff=1408
(per expert) vocab=102400, MoE 64 routed experts top-6 + 2 shared,
MLA kv_lora_rank=512 [arXiv:2405.04434].

Note (DESIGN.md §4): the assignment line lists 'MoE 64e top-6' and
'160 routed'; 160 belongs to full V2 — we follow the explicit
64e top-6 figure of V2-Lite."""
from repro_torch.models.common import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    long_context_window=4096,     # long_500k via SWA variant
    moe=MoEConfig(num_experts=64, experts_per_token=6, d_expert=1408,
                  num_shared_experts=2),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    source="arXiv:2405.04434",
)
