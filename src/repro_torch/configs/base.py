"""Model/config system (port of `repro/configs/base.py`).

A copy of the JAX package's plain dataclasses, so the port imports nothing
of `repro`. Field for field the same as the reference (a test holds them
equal). Registered: the Switch family, the decoder-only attention
configs, the hybrid hymba, the recurrent xlstm and the encoder-decoder
seamless.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts settings for a layer stack."""

    num_experts: int = 0              # routed experts (0 => dense FFN)
    top_k: int = 1
    d_expert: int = 0                 # hidden dim of each routed expert
    num_shared_experts: int = 0       # DeepSeek-style always-on experts
    d_shared: int = 0                 # hidden dim of each shared expert
    capacity_factor: float = 1.25     # train-time capacity for dispatch
    router_aux_coef: float = 0.01     # load-balance loss weight
    router_z_coef: float = 1e-3       # router z-loss weight
    moe_every: int = 1                # MoE layer stride (1 => every layer)
    # the router's scores: "softmax" over all experts, or "sigmoid" a
    # score (nemotron_h: top-k on score + a per-expert correction bias,
    # leaf `router_bias`, the chosen scores renormalised)
    score_func: str = "softmax"
    routed_scaling_factor: float = 1.0  # the routed experts' weights times this

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class AttnConfig:
    """Attention settings."""

    qkv_bias: bool = False
    qk_norm: bool = False             # chameleon-style per-head q/k RMSNorm
    logit_softcap: float = 0.0        # gemma2 attention softcap (0 = off)
    window: int = 0                   # sliding-window size (0 = full)
    # per-layer pattern cycled over depth, entries: "local" | "global", in
    # a jamba stack "mamba" (that sublayer's mixer is Mamba, not attention),
    # and in a nemotron_h stack one a block: "mamba2" | "moe" | "global"
    layer_pattern: Tuple[str, ...] = ("global",)
    rope_theta: float = 10000.0       # 0 = no positional encoding (jamba, nemotron_h)


@dataclass(frozen=True)
class PrefetchConfig:
    """Async expert-prefetch pipeline settings (serving-time).

    `depth` is the lookahead: how many prediction batches may have uploads
    outstanding at once (bounds both transfer-queue backpressure and the
    eviction-protection working set). `staging_buffers` sizes the host
    staging ring the transfer thread double-buffers H2D copies through."""

    enabled: bool = False
    depth: int = 2                    # max outstanding prefetch tickets
    staging_buffers: int = 2          # host staging slabs (2 = double-buffered)
    # fault tolerance (see core/faults.py and ARCHITECTURE.md "Failure
    # model"): a failed upload batch is retried with bounded exponential
    # backoff; exhausted retries poison its fences, and `degrade_after`
    # consecutive abandonments flip the shard to the synchronous path
    max_retries: int = 3              # upload attempts = 1 + max_retries
    backoff_s: float = 0.002          # base backoff (doubles per attempt)
    degrade_after: int = 3            # consecutive failures -> degraded mode


@dataclass(frozen=True)
class SpecConfig:
    """Speculative multi-token decode settings (serving-time).

    The LSTM hash predictor already runs ahead of the model; `mode="draft"`
    additionally reads a tied-embedding next-token head off the same
    predictor state, unrolls it `k` steps to propose a draft block, and
    verifies the whole block in one jitted k-position decode. The union of
    the k positions' predicted expert sets ships as a single multi-token
    prefetch ticket (a strict superset of each per-step ticket), so
    speculation deepens expert-prefetch lookahead for free."""

    mode: str = "off"                 # "off" | "draft"
    k: int = 4                        # draft tokens proposed per verify step

    @property
    def enabled(self) -> bool:
        return self.mode != "off" and self.k > 1


@dataclass(frozen=True)
class TierConfig:
    """Hierarchical residency tiers for the device expert cache.

    With `int4_slots` the slot pool splits into a HOT tier (int8 slots, the
    existing fused-dequant format) and a WARM tier (int4 group-quantized
    slots — ~2× more resident experts per byte at coarser precision); cold
    experts stay on host. The decayed α-mass EMA drives promotion/demotion
    between the tiers (see ExpertStore.plan_layer).

    `tier_split` is the share of the slot-BYTE budget spent on hot int8
    slots; the remainder buys warm int4 slots (so `slots_per_layer` keeps
    meaning "budget in int8-slot units" — the equal-bytes currency every
    capacity bench uses). `warm_slots` overrides the derived warm count
    directly. `group_size` is the int4 contraction-axis scale group (one f32
    scale per `group_size` input channels per output channel); 64 keeps the
    scale-plane overhead low enough for ≥1.8× capacity vs int8 on the
    miniature configs. `promote_margin` is the promotion hysteresis: a warm
    expert promotes only when its decayed α mass exceeds `promote_margin ×`
    the coldest demotable hot expert's (or a hot slot is free)."""

    int4_slots: bool = False
    tier_split: float = 0.5
    group_size: int = 64
    promote_margin: float = 1.25
    warm_slots: Optional[int] = None

    @property
    def enabled(self) -> bool:
        return self.int4_slots


@dataclass(frozen=True)
class QuantConfig:
    """Expert-weight quantization settings (serving-time).

    `quantized_slots` makes int8 the *native residency format*: device slot
    pools hold int8 expert weights plus per-expert scale planes, uploads move
    quantized slabs with no dequant hop, and the expert FFN dequantizes
    in-kernel (fused) — so a fixed slot-byte budget holds 2–4× more experts
    than fp slots. `scale_granularity` picks how scales are computed:
    "channel" (per-output-channel absmax, tighter) or "tensor" (one scale per
    expert tensor, coarser but smaller metadata); storage is always a
    per-channel plane so kernels stay uniform.

    `tier` adds the hot/warm/cold residency hierarchy on top (int4 warm
    slots; requires `quantized_slots` — see TierConfig)."""

    quantized_slots: bool = False
    scale_granularity: str = "channel"  # "channel" | "tensor"
    tier: TierConfig = field(default_factory=TierConfig)


@dataclass(frozen=True)
class SSMConfig:
    """State-space / recurrent block settings (mamba + xLSTM)."""

    state_dim: int = 16               # mamba N (per-channel state; Mamba-2's per group)
    conv_dim: int = 4                 # mamba depthwise conv width
    expand: int = 2                   # mamba inner expansion
    # Mamba-2 (nemotron_h): d_inner = mamba2_heads * mamba2_head_dim; B and
    # C in `n_groups` groups of state_dim, shared by heads / n_groups heads;
    # the SSD's chunk length
    mamba2_heads: int = 0
    mamba2_head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 128
    # xLSTM: pattern over depth, entries: "m" (mLSTM) | "s" (sLSTM)
    xlstm_pattern: Tuple[str, ...] = ()
    xlstm_heads: int = 4


# ---------------------------------------------------------------------------
# Main config
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "audio")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # one of FAMILIES
    citation: str = ""                # source paper / model card

    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    head_dim: int = 0                 # 0 => d_model // n_heads
    d_ff: int = 256                   # dense FFN hidden (ignored if pure-MoE)
    vocab_size: int = 1024

    act: str = "silu"                 # "silu" | "gelu" | "relu" | "relu2" (relu squared)
    glu: bool = True                  # gated FFN (SwiGLU/GeGLU)
    norm_eps: float = 1e-6
    post_norm: bool = False           # gemma2 extra post-sublayer norms
    tie_embeddings: bool = True
    final_logit_softcap: float = 0.0  # gemma2
    embed_scale: bool = False         # gemma2 multiplies embeddings by sqrt(d)

    moe: MoEConfig = field(default_factory=MoEConfig)
    attn: AttnConfig = field(default_factory=AttnConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    prefetch: PrefetchConfig = field(default_factory=PrefetchConfig)
    quant: QuantConfig = field(default_factory=QuantConfig)
    spec: SpecConfig = field(default_factory=SpecConfig)

    # block layout: "attn" (transformer), "hymba" (parallel attn+ssm),
    # "xlstm" (recurrent-only stack), "jamba" (each sublayer's mixer is
    # attention or Mamba as `attn.layer_pattern` says, then a dense or MoE
    # FFN), "nemotron_h" (each block one mixer, `x += mixer(norm(x))`: Mamba-2,
    # MoE or attention as `attn.layer_pattern` says, no FFN after it)
    block_kind: str = "attn"

    # encoder-decoder (audio)
    enc_dec: bool = False
    n_enc_layers: int = 0

    # modality frontend stub: "text" | "audio" | "vision"
    modality: str = "text"

    dtype: str = "bfloat16"

    # ---- derived -----------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (§Perf hillclimb #2).

        Unpadded odd vocabs (seamless 256206, hymba 32001) cannot shard
        over the model axis, leaving the f32 [B,S,V] logits replicated —
        67 GB/device at train_4k. Padding is the standard production fix
        (MaxText pads too); padded logit columns are masked to -inf in
        `unembed` so they are unreachable by loss/argmax/sampling.
        """
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k-token contexts?  (see DESIGN.md)"""
        if self.block_kind in ("xlstm", "hymba"):
            return True
        # dense archs qualify only with a native sliding-window variant
        return self.attn.window > 0

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path (enc-dec: decoder)

    def pattern_at(self, layer: int) -> str:
        p = self.attn.layer_pattern
        return p[layer % len(p)]

    def layer_window(self, layer: int) -> int:
        """Effective attention window for a layer (0 = full; 0 too for a
        jamba "mamba" sublayer, which holds no K/V)."""
        if self.block_kind == "hymba":
            return self.attn.window
        if self.pattern_at(layer) == "local":
            return self.attn.window
        return 0

    # ---- param accounting (used by memory benches / Table 2) ----------
    def param_counts(self) -> dict:
        d, hd = self.d_model, self.hd
        nq, nkv = self.n_heads, self.n_kv_heads
        attn = d * hd * nq + 2 * d * hd * nkv + hd * nq * d
        if self.attn.qkv_bias:
            attn += hd * (nq + 2 * nkv)
        ffn_mult = 3 if self.glu else 2
        dense_ffn = ffn_mult * d * self.d_ff if self.d_ff else 0
        expert = ffn_mult * d * self.moe.d_expert if self.moe.enabled else 0
        shared = ffn_mult * d * self.moe.d_shared * self.moe.num_shared_experts
        router = d * self.moe.num_experts if self.moe.enabled else 0
        if self.block_kind == "jamba":
            return self._jamba_param_counts(attn, dense_ffn, expert, router)
        if self.block_kind == "nemotron_h":
            return self._nemotron_param_counts(attn, expert, router)
        if self.block_kind == "xlstm":
            per_layer = 8 * d * d  # coarse: proj + gates
            moe_total = 0
        elif self.moe.enabled:
            per_layer = attn + router + shared + expert * self.moe.num_experts
            moe_total = self.n_layers * expert * self.moe.num_experts
        else:
            per_layer = attn + dense_ffn
            moe_total = 0
        if self.block_kind == "hymba":
            per_layer += 4 * d * d  # ssm branch
        n_blocks = self.n_layers + (self.n_enc_layers if self.enc_dec else 0)
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = n_blocks * per_layer + embed
        return {
            "total": total,
            "moe": moe_total,
            "active": total - moe_total
            + (self.n_layers * expert * (self.moe.top_k) if self.moe.enabled else 0),
            "embed": embed,
        }

    def _jamba_param_counts(self, attn: int, dense_ffn: int, expert: int, router: int) -> dict:
        """Layer by layer: the mixer `layer_pattern` names (attention, or a
        Mamba with its projections, conv, Δ / B / C norms, A and D), then the
        MoE FFN on every `moe_every`-th layer and the dense one elsewhere."""
        d, s = self.d_model, self.ssm
        di, N = s.expand * d, s.state_dim
        R = -(-d // 16)
        mamba = (d * 2 * di + s.conv_dim * di + di + di * (R + 2 * N) + R * di + di
                 + R + 2 * N + di * N + di + di * d)
        every = self.moe.moe_every
        total = moe_total = 0
        for layer in range(self.n_layers):
            total += 2 * d + (attn if self.pattern_at(layer) == "global" else mamba)
            if self.moe.enabled and layer % every == every - 1:
                total += router + expert * self.moe.num_experts
                moe_total += expert * self.moe.num_experts
            else:
                total += dense_ffn
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total += embed + d
        active = total - moe_total + moe_total // max(1, self.moe.num_experts) * self.moe.top_k
        return {"total": total, "moe": moe_total, "active": active, "embed": embed}

    def _nemotron_param_counts(self, attn: int, expert: int, router: int) -> dict:
        """Block by block, each one norm and the mixer `layer_pattern` names:
        attention; Mamba-2 (its in projection to z, xBC and dt, the conv
        over xBC with its bias, dt_bias / A_log / D a head, the grouped
        norm, the out projection); or the MoE (routed experts, shared
        expert, router and its correction bias)."""
        d, s, m = self.d_model, self.ssm, self.moe
        di = s.mamba2_heads * s.mamba2_head_dim
        conv = di + 2 * s.n_groups * s.state_dim
        mamba2 = (d * (di + conv + s.mamba2_heads) + (s.conv_dim + 1) * conv
                  + 3 * s.mamba2_heads + di + di * d)
        shared = (3 if self.glu else 2) * d * m.d_shared * m.num_shared_experts
        moe = expert * m.num_experts + shared + router + m.num_experts   # + the correction bias
        total = moe_total = 0
        for layer in range(self.n_layers):
            kind = self.pattern_at(layer)
            total += d + {"global": attn, "mamba2": mamba2, "moe": moe}[kind]
            moe_total += expert * m.num_experts if kind == "moe" else 0
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total += embed + d
        active = total - moe_total + moe_total // max(1, m.num_experts) * m.top_k
        return {"total": total, "moe": moe_total, "active": active, "embed": embed}

    def bytes_per_param(self) -> int:
        return {"bfloat16": 2, "float32": 4, "float16": 2}[self.dtype]

    # ---- reduced variant for CPU smoke tests --------------------------
    def reduced(self) -> "ModelConfig":
        """Same family/features, laptop-sized: 2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 128)
        nh = max(1, min(self.n_heads, 4))
        nkv = max(1, min(self.n_kv_heads, nh))
        while nh % nkv:
            nkv -= 1
        moe = self.moe
        if moe.enabled:
            moe = replace(
                moe,
                num_experts=min(moe.num_experts, 4),
                top_k=min(moe.top_k, 2),
                d_expert=min(moe.d_expert, 64) or 64,
                num_shared_experts=min(moe.num_shared_experts, 1),
                d_shared=min(moe.d_shared, 64) if moe.d_shared else 0,
            )
        attn = replace(
            self.attn,
            window=min(self.attn.window, 64) if self.attn.window else 0,
        )
        ssm = replace(
            self.ssm,
            state_dim=min(self.ssm.state_dim, 8),
            xlstm_heads=max(1, min(self.ssm.xlstm_heads, 2)),
            xlstm_pattern=self.ssm.xlstm_pattern[:2] or self.ssm.xlstm_pattern,
        )
        return replace(
            self,
            n_layers=2,
            n_enc_layers=2 if self.enc_dec else 0,
            d_model=d,
            n_heads=nh,
            n_kv_heads=nkv,
            head_dim=min(self.hd, 32),
            d_ff=min(self.d_ff, 256),
            vocab_size=min(self.vocab_size, 512),
            moe=moe,
            attn=attn,
            ssm=ssm,
            dtype="float32",
        )


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    assert cfg.family in FAMILIES, cfg.family
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> Sequence[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    # import side-effect registers configs
    from repro_torch.configs import (  # noqa: F401
        chameleon_34b,
        deepseek_moe_16b,
        gemma2_9b,
        hymba_1_5b,
        qwen2_1_5b,
        qwen3_moe_235b_a22b,
        seamless_m4t_medium,
        smollm_135m,
        stablelm_12b,
        switch_base,
        xlstm_125m,
    )


def shape_supported(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether (arch, shape) is part of the coverage matrix; reason if not."""
    if shape.kind == "decode" and shape.seq_len > 100_000 and not cfg.sub_quadratic:
        return False, "long_500k skipped: pure full-attention arch (DESIGN.md)"
    return True, ""
