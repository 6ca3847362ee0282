"""gemma2-27b [dense] — local+global alternating, logit softcap
[arXiv:2408.00118; hf]."""
from ..models.config import LayerSlot, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    pattern=(LayerSlot("attn_local", "dense"),
             LayerSlot("attn_global", "dense")),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    rope_theta=10000.0,
    embed_scale=True,
    tie_embeddings=True,
    loss_chunk=512,
)
