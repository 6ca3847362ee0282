"""recurrentgemma-2b [hybrid] — RG-LRU + local attn, 1:2
[arXiv:2402.19427; hf]."""
from ..models.config import LayerSlot, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    pattern=(LayerSlot("rec", "dense"),
             LayerSlot("rec", "dense"),
             LayerSlot("attn_local", "dense")),
    window=2048,
    rec_heads=1,
    rec_dim=2560,
    conv_width=4,
    embed_scale=True,
    tie_embeddings=True,
    loss_chunk=512,
)
