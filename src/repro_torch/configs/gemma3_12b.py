"""gemma3-12b [dense] — 5:1 local:global, 128k context
[hf:google/gemma-3-1b-pt; unverified]."""
from ..models.config import LayerSlot, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    pattern=(LayerSlot("attn_local", "dense"),) * 5
            + (LayerSlot("attn_global", "dense"),),
    window=1024,
    qk_norm=True,
    rope_theta=1_000_000.0,
    embed_scale=True,
    tie_embeddings=True,
    loss_chunk=512,
)
