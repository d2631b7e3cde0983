"""Architecture + shape configuration system (plain data).

Counterpart of ``repro/configs/base.py``: every assigned architecture is an
``ArchConfig`` (exact published numbers) in ``repro_torch/configs/<id>.py``,
and each config knows how to produce a ``reduced()`` variant for CPU tests.
Dtypes stay strings, as in the reference; the models turn them into torch
dtypes.  ``token_batch_spec`` gives a step's inputs as ``device="meta"``
tensors, which hold a shape and a dtype and no memory, for the dry run
(``launch/dryrun.py``).

Shapes (assigned):
    train_4k     seq_len=4096    global_batch=256   -> train_step
    prefill_32k  seq_len=32768   global_batch=32    -> serve prefill
    decode_32k   seq_len=32768   global_batch=128   -> serve decode (1 token, cache=seq_len)
    long_500k    seq_len=524288  global_batch=1     -> serve decode, sub-quadratic archs only
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (seq_len, global_batch) workload shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"
    sub_quadratic_only: bool = False


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode", sub_quadratic_only=True),
}


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    """Exact architecture hyper-parameters (published numbers).

    ``family`` selects the substrate:
      dense   - decoder-only GQA transformer
      moe     - decoder-only GQA transformer with MoE FFN (optionally + dense residual)
      ssm     - attention-free Mamba1 stack
      hybrid  - RG-LRU + local attention (RecurrentGemma pattern, 2 LRU : 1 attn)
      audio   - encoder/decoder transformer; frontend stubbed (frame embeddings)
      vlm     - decoder-only GQA transformer + cross-attn image layers; patch
                embeddings stubbed
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    source: str = ""

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False  # arctic: dense MLP residual in parallel
    capacity_factor: float = 1.25
    moe_group_size: int = 256  # token group size for capacity-based dispatch

    # --- SSM (mamba1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    ssm_chunk: int = 256  # seq chunk for train-time scan
    ssm_scan: str = "assoc"  # "assoc" (tree scan) | "seq" (strip-mined, §Perf)

    # --- hybrid (RG-LRU) ---
    rnn_width: int = 0  # 0 -> d_model
    local_window: int = 2048
    block_pattern: tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")

    # --- enc-dec (audio) ---
    n_enc_layers: int = 0
    enc_len_train: int = 4096  # stub frontend frames for train shape
    enc_len_serve: int = 4096

    # --- vlm ---
    cross_attn_period: int = 0  # a cross-attn layer every N layers
    n_img_tokens: int = 1024  # stub patch embeddings

    # --- common knobs ---
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "dots"  # none | dots | full
    logit_chunk: int = 0  # 0 = no chunking of the LM head

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def rnn_dim(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def sub_quadratic(self) -> bool:
        """True when the token mixer cost is sub-quadratic in seq_len."""
        return self.family in ("ssm", "hybrid")

    @property
    def is_enc_dec(self) -> bool:
        return self.family == "audio"

    def supports(self, shape: ShapeConfig) -> bool:
        """Whether this arch runs the given assigned shape (see DESIGN.md)."""
        if shape.sub_quadratic_only and not self.sub_quadratic:
            return False
        return True

    # ------------------------------------------------------------------
    # Parameter counting (for MODEL_FLOPS = 6*N*D and memory estimates)
    # ------------------------------------------------------------------
    def param_count(self, active_only: bool = False) -> int:
        d, f, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        emb = V * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            return d * H * hd + 2 * d * KV * hd + H * hd * d

        def mlp_params(ff: int) -> int:
            return 3 * d * ff  # SwiGLU: gate, up, down

        if self.family == "dense":
            per = attn_params() + mlp_params(f) + 2 * d
            return L * per + emb + d
        if self.family == "vlm":
            # every `period`-th layer is a gated cross-attn block (replacing,
            # not adding to, a self-attn layer)
            n_x = L // self.cross_attn_period if self.cross_attn_period else 0
            n_self = L - n_x
            per_self = attn_params() + mlp_params(f) + 2 * d
            per_x = attn_params() + mlp_params(f) + 2 * d + 2  # + 2 scalar gates
            return n_self * per_self + n_x * per_x + emb + d
        if self.family == "moe":
            E, K = self.n_experts, self.top_k
            router = d * E
            per_expert = mlp_params(f)
            dense_res = mlp_params(f) if self.moe_dense_residual else 0
            per = attn_params() + router + E * per_expert + dense_res + 2 * d
            if active_only:
                per = attn_params() + router + K * per_expert + dense_res + 2 * d
            return L * per + emb + d
        if self.family == "ssm":
            di, N, R, C = self.d_inner, self.ssm_state, self.dt_rank, self.ssm_conv
            per = (
                d * 2 * di  # in_proj
                + di * C  # conv
                + di * (R + 2 * N)  # x_proj -> dt, B, C
                + R * di + di  # dt_proj
                + di * N + di  # A_log, D
                + di * d  # out_proj
                + d  # norm
            )
            return L * per + emb + d
        if self.family == "hybrid":
            dr = self.rnn_dim
            nb = 16
            while dr % nb:
                nb //= 2
            nb = max(nb, 1)
            rec = (
                2 * d * dr  # w_x, w_gate
                + dr * 4 + dr  # conv1d width 4 + bias
                + 2 * (dr * dr // nb) + 2 * dr  # block-diagonal RG-LRU gates + biases
                + dr  # Lambda
                + dr * d  # out proj
                + 2 * d  # norms
                + mlp_params(f)
            )
            attn = attn_params() + 2 * d + mlp_params(f)
            n_attn = sum(1 for i in range(L) if self.layer_kind(i) == "attn")
            n_rec = L - n_attn
            return n_rec * rec + n_attn * attn + emb + d
        if self.family == "audio":
            Le, Ld = self.n_enc_layers, self.n_layers
            enc = Le * (attn_params() + mlp_params(f) + 2 * d)
            dec = Ld * (2 * attn_params() + mlp_params(f) + 3 * d)
            return enc + dec + emb + 2 * d
        raise ValueError(self.family)

    def layer_kind(self, i: int) -> str:
        """Layer type at depth i (hybrid/vlm patterns)."""
        if self.family == "hybrid":
            pat = self.block_pattern or ("rec", "rec", "attn")
            return pat[i % len(pat)]
        if self.family == "vlm" and self.cross_attn_period:
            return "xattn" if (i % self.cross_attn_period == self.cross_attn_period - 1) else "self"
        return "self"

    # ------------------------------------------------------------------
    def replace(self, **kw: Any) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """A tiny same-family variant for CPU smoke tests."""
        kw: dict[str, Any] = dict(
            n_layers=max(2, _pattern_len(self)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            param_dtype="float32",
            compute_dtype="float32",
            remat="none",
        )
        if self.family == "moe":
            # capacity_factor = E/k -> capacity == group: no token ever drops,
            # so results are group-size invariant (makes smoke tests exact).
            kw.update(n_experts=4, top_k=2, moe_group_size=16, capacity_factor=2.0)
        if self.family == "ssm":
            kw.update(ssm_state=4, ssm_chunk=8, ssm_dt_rank=4)
        if self.family == "hybrid":
            kw.update(rnn_width=64, local_window=16, n_layers=2 * len(self.block_pattern or ("rec", "rec", "attn")))
        if self.family == "audio":
            kw.update(n_enc_layers=2, enc_len_train=16, enc_len_serve=16)
        if self.family == "vlm":
            kw.update(cross_attn_period=2, n_img_tokens=8, n_layers=4)
        return self.replace(**kw)


def _pattern_len(cfg: ArchConfig) -> int:
    if cfg.family == "hybrid":
        return len(cfg.block_pattern or ("rec", "rec", "attn"))
    if cfg.family == "vlm" and cfg.cross_attn_period:
        return cfg.cross_attn_period
    return 2


# ---------------------------------------------------------------------------
# Input specs (meta tensors: a shape and a dtype, no memory)
# ---------------------------------------------------------------------------


def token_batch_spec(cfg: ArchConfig, shape: ShapeConfig) -> dict[str, Any]:
    """Abstract input tree for one step of the given kind, as meta tensors
    (``src/repro/configs/base.py:276``):

    train  : {tokens, labels[, enc_frames | img_embeds]}
    prefill: {tokens[, enc_frames | img_embeds]}
    decode : {tokens (B,1), pos (B,)} - cache/state specs come from the model.
    """
    import torch

    B, L = shape.global_batch, shape.seq_len
    i32 = torch.int32
    ct = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.compute_dtype]
    sds = lambda dims, dtype: torch.empty(dims, dtype=dtype, device="meta")
    if shape.kind in ("train", "prefill"):
        batch: dict[str, Any] = {"tokens": sds((B, L), i32)}
        if shape.kind == "train":
            batch["labels"] = sds((B, L), i32)
        enc_len = cfg.enc_len_train if shape.kind == "train" else cfg.enc_len_serve
        if cfg.family == "audio":
            batch["enc_frames"] = sds((B, enc_len, cfg.d_model), ct)
        if cfg.family == "vlm":
            batch["img_embeds"] = sds((B, cfg.n_img_tokens, cfg.d_model), ct)
        return batch
    if shape.kind == "decode":
        return {"tokens": sds((B, 1), i32), "pos": sds((B,), i32)}
    raise ValueError(shape.kind)
