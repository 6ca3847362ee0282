"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, routed experts top-6
[arXiv:2405.04434; hf].

Pool header says "MoE 64e top-6 d_ff=1408" while its note says
"2 shared+160 routed"; we follow the header (64 routed, top-6, 2 shared)
— discrepancy recorded in DESIGN.md §Arch-applicability.
"""
from ..models.config import LayerSlot, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,                 # dense first layer FFN
    vocab_size=102400,
    pattern=(LayerSlot("mla", "moe"),),
    first_dense_layers=1,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_ff_expert=1408,
    mla=True,
    kv_lora_rank=512,
    q_lora_rank=0,              # v2-lite: full-rank q
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    rope_theta=10000.0,
    tie_embeddings=False,
    loss_chunk=512,
)
