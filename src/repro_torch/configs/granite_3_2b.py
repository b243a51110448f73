"""granite-3-2b [dense]: 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155 — GQA [hf:ibm-granite/granite-3.0-2b-base]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    arch_type="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    head_dim=64,
    rope_theta=10_000.0,
    tie_embeddings=True,
    long_context_window=4096,    # long_500k via the SWA variant (DESIGN.md §4)
    source="hf:ibm-granite/granite-3.0-2b-base",
)
