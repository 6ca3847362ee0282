"""qwen2-1.5b [dense] — GQA, QKV bias [arXiv:2407.10671; hf]."""
from ..models.config import LayerSlot, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    pattern=(LayerSlot("attn_global", "dense"),),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    loss_chunk=512,
)
