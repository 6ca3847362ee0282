"""Model configuration schema for all assigned architectures.

The port's own copy of ``repro.models.config`` (pure Python, unchanged:
the same fields, ``reduced()``, ``vocab_padded`` and ``layer_slots()``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

__all__ = ["ModelConfig", "LayerSlot"]


@dataclass(frozen=True)
class LayerSlot:
    """One slot of the repeating layer pattern.

    mixer: attn_global | attn_local | mla | rec | mlstm | slstm |
           attn_cross (decoder cross-attention is added via flag)
    ffn:   dense | moe | none
    """
    mixer: str = "attn_global"
    ffn: str = "dense"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // n_heads

    # layer pattern (cycled); remainder layers use pattern prefix
    pattern: tuple[LayerSlot, ...] = (LayerSlot(),)

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] = ()   # qwen2-vl M-RoPE
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    window: Optional[int] = None
    qk_norm: bool = False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3

    # MLA (DeepSeek)
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0             # 0 → full-rank q projection
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # multi-token prediction (DeepSeek V3)
    mtp_depth: int = 0
    mtp_loss_weight: float = 0.3

    # encoder-decoder (Whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_pattern: tuple[LayerSlot, ...] = ()
    max_target_len: int = 448

    # recurrent (xLSTM / RecurrentGemma)
    rec_heads: int = 0               # heads for mlstm/slstm/rg-lru
    rec_dim: int = 0                 # recurrent width (0 → d_model)
    conv_width: int = 4              # temporal conv in Griffin block
    proj_factor: float = 2.0         # mLSTM block up-projection

    # frontend stubs for [vlm]/[audio]: inputs are precomputed embeddings
    frontend: Optional[str] = None   # None | "patch" | "audio_frames"

    # embeddings / head
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    embed_scale: bool = False        # gemma scales embeddings by sqrt(d)

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # training-side knobs (overridable per run)
    loss_chunk: int = 0              # 0 = unchunked vocab loss
    remat: str = "none"              # none | full | dots
    scan_layers: bool = True

    # ------------------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 (TP divisibility; the
        padded tail is never emitted by data and never labeled)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def uses_attention(self) -> bool:
        return any(s.mixer.startswith(("attn", "mla")) for s in self.pattern)

    @property
    def pure_full_attention(self) -> bool:
        """True if every mixer is global full attention (→ skip long_500k)."""
        mixers = {s.mixer for s in self.pattern}
        return mixers <= {"attn_global", "mla"}

    def layer_slots(self) -> list[LayerSlot]:
        """Materialized per-layer slot list with first_dense override."""
        out = []
        for i in range(self.n_layers):
            s = self.pattern[i % len(self.pattern)]
            if s.ffn == "moe" and i < self.first_dense_layers:
                s = replace(s, ffn="dense")
            out.append(s)
        return out

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        period = len(self.pattern)
        defaults = dict(
            n_layers=max(period, 2 if period == 1 else period),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 1,
            head_dim=16,
            d_ff=128,
            vocab_size=128,
            first_dense_layers=min(self.first_dense_layers, 1),
            loss_chunk=0,
        )
        if self.n_experts:
            defaults.update(n_experts=4, top_k=2, d_ff_expert=32,
                            n_shared_experts=min(self.n_shared_experts, 1))
        if self.mla:
            defaults.update(kv_lora_rank=32, q_lora_rank=0, qk_nope_dim=16,
                            qk_rope_dim=8, v_head_dim=16)
        if self.is_encoder_decoder:
            defaults.update(encoder_layers=2, max_target_len=16)
        if self.rec_heads:
            defaults.update(rec_heads=2, rec_dim=0)
        if self.window is not None:
            defaults.update(window=16)
        if self.mtp_depth:
            defaults.update(mtp_depth=1)
        if self.mrope_sections:
            defaults.update(mrope_sections=(2, 3, 3))  # sums to head_dim/2
        defaults.update(overrides)
        return replace(self, **defaults)

    # ------------------------------------------------------------------
    # analytic parameter / FLOP accounting (for roofline MODEL_FLOPS)
    # ------------------------------------------------------------------
    def param_counts(self) -> dict:
        d, hd = self.d_model, self.resolved_head_dim
        H, Hkv = self.n_heads, self.n_kv_heads
        embed = self.vocab_size * d
        per_layer_dense_ffn = 3 * d * self.d_ff
        if self.mla:
            attn = (self.kv_lora_rank * (d + H * (self.qk_nope_dim + self.v_head_dim))
                    + d * self.qk_rope_dim
                    + (self.q_lora_rank * (d + H * (self.qk_nope_dim + self.qk_rope_dim))
                       if self.q_lora_rank else d * H * (self.qk_nope_dim + self.qk_rope_dim))
                    + H * self.v_head_dim * d)
        else:
            attn = d * (H * hd) + 2 * d * (Hkv * hd) + (H * hd) * d
        expert_ffn = 3 * d * self.d_ff_expert if self.d_ff_expert else 0
        total = embed if self.tie_embeddings else 2 * embed
        active = total
        for slot in self.layer_slots():
            if slot.mixer.startswith("attn") or slot.mixer == "mla":
                total += attn
                active += attn
            elif slot.mixer == "rec":
                rec = self.rec_dim or self.d_model
                blk = 2 * d * rec + rec * d + 3 * rec + self.conv_width * rec
                total += blk
                active += blk
            elif slot.mixer in ("mlstm", "slstm"):
                inner = int(d * self.proj_factor)
                blk = d * inner * 2 + inner * d + 4 * inner * inner // max(self.rec_heads, 1)
                total += blk
                active += blk
            if slot.ffn == "dense":
                total += per_layer_dense_ffn
                active += per_layer_dense_ffn
            elif slot.ffn == "moe":
                total += self.n_experts * expert_ffn
                total += self.n_shared_experts * expert_ffn
                total += d * self.n_experts  # router
                active += (self.top_k + self.n_shared_experts) * expert_ffn
                active += d * self.n_experts
        return {"total": int(total), "active": int(active)}
