"""Model configuration schema, a copy of the JAX package's
``models/config.py`` (same fields and defaults, so one config means the
same model in both packages).

A model is a stack of *layer groups*; each group is a repeating period of
layer specs repeated ``repeat`` times.  The port builds one module per
layer and walks them in order (the JAX package scans stacked params);
its first slice runs the ``attn`` mixer with the ``mlp`` and ``sparse``
FFN arms and rejects the other fields' non-default values at ``LM``
construction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    router_z_weight: float = 0.0
    router_score: str = "softmax"     # "softmax" | "sigmoid" (deepseek v3)
    norm_topk_prob: bool = True
    # perf levers (EXPERIMENTS.md §Perf): baseline values are the
    # paper-faithful/naive choices, the alternatives are the hillclimbed ones
    combine_dtype: str = "float32"    # "bfloat16" halves the combine
                                      # all-reduce volume over `model`
    ranking: str = "cumsum"           # "sort": O(Tk logTk) slot ranking vs
                                      # the O(Tk*E) cumsum-over-onehot
    impl: str = "gspmd"               # "shard_map": explicit local EP
                                      # dispatch + one psum (see §Perf)


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer within a period."""
    mixer: str = "attn"        # "attn" | "attn_local" | "mla" | "mamba"
    ffn: str = "mlp"           # "mlp" | "moe" | "sparse" | "none"
    cross: bool = False        # add cross-attention over encoder memory
    causal: bool = True        # False for encoder self-attention


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str                       # dense|moe|vlm|hybrid|ssm|audio
    d_model: int
    vocab_size: int
    # attention geometry (ignored for pure-SSM)
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    # layer stacking: list of (period, repeat)
    groups: Tuple[Tuple[Tuple[LayerSpec, ...], int], ...] = ()
    # attention options
    attn_impl: str = "gqa"            # "gqa" | "mla"
    qkv_bias: bool = False
    qk_norm: bool = False             # qwen3-style per-head RMS on q/k
    use_rope: bool = True             # False: no positional encoding (jamba)
    rope_theta: float = 10000.0
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    attn_scale: Optional[float] = None   # override 1/sqrt(dh) (gemma2)
    local_window: int = 4096          # for attn_local layers
    global_prefix: int = 0            # block-sparse global tokens
    attn_tile_q: int = 512            # XLA chunked-attention tile sizes
    attn_tile_kv: int = 512
    attn_schedule: str = "row"        # "row" | "balanced" (see §Perf)
    # long-context (long_500k) retained-block cache: local window blocks +
    # global prefix kept, O(window) decode -- the paper's static block
    # sparsity making the 500k cell feasible (DESIGN.md §3)
    retained_window: int = 4096
    retained_prefix: int = 1024
    # MLA geometry (deepseek)
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # activation / norm
    act: str = "silu"                 # silu (gated) | gelu (gated) | gelu_plain
    norm_eps: float = 1e-6
    post_norm: bool = False           # gemma2 uses pre+post norms
    tie_embeddings: bool = True
    embed_scale: bool = False         # gemma-style sqrt(d_model) scaling
    # sub-configs
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    # enc-dec
    encoder_layers: int = 0
    # modality frontend stub (precomputed embeddings per the brief)
    frontend: Optional[str] = None    # "vision" | "audio" | None
    frontend_len: int = 0             # prepended embedding positions
    # --- the paper's technique -------------------------------------------
    ffn_density: Optional[float] = None  # static block-sparse FFN if set
    ffn_block_size: int = 16
    long_attention: str = "full"      # "full" | "block_sparse"
    # numerics
    dtype: str = "bfloat16"
    remat: str = "full"               # "full" | "dots" | "none"
    # sequence-parallel residual stream: shard S over 'model' between
    # layers so TP-boundary all-reduces become reduce-scatter/all-gather
    # pairs and norms run on S/|model| rows (§Perf lever)
    seq_shard: bool = False

    # ---------------------------------------------------------------------
    @property
    def num_layers(self) -> int:
        return sum(len(period) * rep for period, rep in self.groups)

    @property
    def attn_dims(self) -> Tuple[int, int]:
        """(q_dim, kv_dim) of the projected attention space."""
        return (self.num_heads * self.head_dim,
                self.num_kv_heads * self.head_dim)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline term)."""
        d = self.d_model
        total = self.vocab_size * d
        if not self.tie_embeddings:
            total += self.vocab_size * d
        for period, rep in self.groups:
            for spec in period:
                total += rep * self._layer_params(spec)
        total += d  # final norm
        if self.encoder_layers:
            enc_spec = LayerSpec(mixer="attn", ffn="mlp")
            total += self.encoder_layers * self._layer_params(enc_spec)
            # cross-attention in every decoder layer
            total += self.num_layers * self._attn_params()
        return total

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attn_impl == "mla":
            qd = self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
            p = d * qd if self.q_lora_rank is None else (
                d * self.q_lora_rank + self.q_lora_rank * qd)
            p += d * (self.kv_lora_rank + self.qk_rope_dim)
            p += self.kv_lora_rank * self.num_heads * (
                self.qk_nope_dim + self.v_head_dim)
            p += self.num_heads * self.v_head_dim * d
            return p
        qd, kvd = self.attn_dims
        return d * qd + 2 * d * kvd + qd * d

    def _ffn_params(self, kind: str) -> int:
        d = self.d_model
        if kind == "none":
            return 0
        if kind == "moe":
            m = self.moe
            gated = 3 if self.act in ("silu", "gelu") else 2
            p = d * m.num_experts  # router
            p += m.num_experts * gated * d * m.d_ff_expert
            p += m.num_shared * gated * d * m.d_ff_shared
            return p
        gated = 3 if self.act in ("silu", "gelu") else 2
        p = gated * d * self.d_ff
        if kind == "sparse" and self.ffn_density is not None:
            p = int(p * self.ffn_density)
        return p

    def _layer_params(self, spec: LayerSpec) -> int:
        d = self.d_model
        p = 2 * d  # two norms
        if spec.mixer in ("attn", "attn_local"):
            p += self._attn_params()
        elif spec.mixer == "mla":
            p += self._attn_params()
        elif spec.mixer == "mamba":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.num_heads(d)
            p += d * (2 * di + 2 * s.d_state + nh)  # in_proj (z,x,B,C,dt)
            p += (di + 2 * s.d_state) * s.d_conv    # conv
            p += nh * 2                             # A, D
            p += di * d                             # out_proj
        p += self._ffn_params(spec.ffn)
        return p

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE top-k active; sparse FFN at
        density) -- the ``N_active`` of the 6·N_active·D MoE roofline."""
        if self.moe is None:
            return self.param_count()
        total = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model
        m = self.moe
        gated = 3
        active_expert = m.top_k * gated * self.d_model * m.d_ff_expert + \
            m.num_shared * gated * self.d_model * m.d_ff_shared + \
            self.d_model * m.num_experts
        for period, rep in self.groups:
            for spec in period:
                if spec.ffn == "moe":
                    p = 2 * self.d_model + active_expert
                    if spec.mixer != "none":
                        p += self._attn_params() if spec.mixer != "mamba" \
                            else (self._layer_params(
                                LayerSpec("mamba", "none")) - 2 * self.d_model)
                    total += rep * p
                else:
                    total += rep * self._layer_params(spec)
        total += self.d_model
        return total


def uniform_groups(n_layers: int, spec: LayerSpec):
    return ((( spec,), n_layers),)
