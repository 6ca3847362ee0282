"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2412.08905; hf]."""
from ..models.config import LayerSlot, ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    pattern=(LayerSlot("attn_global", "dense"),),
    rope_theta=10000.0,
    tie_embeddings=True,
    loss_chunk=512,
)
