"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

d_ff=0 per the pool spec: xLSTM blocks carry their own projections
(mLSTM up-factor 2; sLSTM has a 4/3 GeGLU tail). Pattern period 8 at the
xLSTM[7:1] ratio.
"""
from ..models.config import LayerSlot, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern=(LayerSlot("mlstm", "none"),) * 7 + (LayerSlot("slstm", "none"),),
    rec_heads=4,
    proj_factor=2.0,
    tie_embeddings=True,
    loss_chunk=512,
)
