"""Roofline terms of a dry-run step.

    compute term    = FLOPs a device / PEAK_FLOPS_BF16
    memory term     = bytes a device / HBM_BW
    collective term = collective bytes a device / LINK_BW

with the H100 constants of :mod:`repro_torch.launch.mesh`. The JAX package
reads these counts from a compiled HLO module; the port counts them on the
meta device (``repro_torch.launch.dryrun``): FLOPs of the matmul-class ops
by ``torch.utils.flop_counter``'s rules plus each hand-written kernel's
:func:`kernel_work`, bytes of every op's operands and result (unfused: an
upper bound on the traffic), collective bytes from the sharding rules
(:func:`collective_bytes`). :class:`Roofline` keeps JAX's field names (the
``hlo_`` prefix included) and ``to_dict`` keys, so ``report`` and
``core.workloads.llm_workload`` read the port's records as JAX's.

Each kernel's work count lives with the kernels (``kernels/work.py``);
this module re-exports it beside :func:`bound` and the constants, so a
kernel's bound reads one module.
"""

from __future__ import annotations

import dataclasses
import json
import math

from repro_torch.kernels.work import KERNELS, causal_pairs, kernel_work  # noqa: F401
from repro_torch.launch.mesh import (
    HBM_BW,
    LINK_BW,
    PEAK_FLOPS_BF16,
    PEAK_FLOPS_FP32,
)
from repro_torch.models.moe import capacity
from repro_torch.sharding.partition import mesh_axes, shard_count, spec_axes

PEAK_FLOPS = {"bf16": PEAK_FLOPS_BF16, "fp32": PEAK_FLOPS_FP32}


def bound(nbytes: float, flops: float, dtype: str = "bf16") -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over HBM_BW and the operations over the peak
    for ``dtype`` ("bf16" tensor cores, "fp32" CUDA cores)."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

# --------------------------------------------------------------------------- #
# Model FLOPs
# --------------------------------------------------------------------------- #
def model_flops(cfg, shape) -> float:
    """6*N*D for training; 2*N*D per generated/processed token for serving
    (the JAX package's count)."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq


def train_step_flops(cfg, n_params: int, B: int, S: int) -> int:
    """A training step's model FLOPs as ``chip_smoke.py`` phase 16 reads its
    share of peak: 6 N T over the parameters a token passes through (an MoE
    layer's top-k experts, not all of them) plus causal attention's 6 (hd_qk
    + hd_v) a (query, key) pair a head; the SSD scan's own products are not
    counted."""
    active = n_params
    for i in range(cfg.n_layers):
        if cfg.layer_is_moe(i):
            active -= ((cfg.moe.n_experts - cfg.moe.top_k) * 3 * cfg.d_model
                       * cfg.moe.d_ff)
    if cfg.mla is not None:
        hd_qk = cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim
        hd_v = cfg.mla.v_head_dim
    else:
        hd_qk = hd_v = cfg.head_dim
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    attn = 6 * (hd_qk + hd_v) * (S * (S + 1) // 2) * B * cfg.n_heads * n_attn
    return 6 * active * B * S + attn


# --------------------------------------------------------------------------- #
# Collective bytes from the rules
# --------------------------------------------------------------------------- #
def _wire(kind: str, nbytes: float) -> float:
    """JAX's ring-algorithm factors, (n-1)/n dropped: all-gather the result,
    all-reduce twice the operand, reduce-scatter the input, all-to-all and
    collective-permute the size."""
    return 2 * nbytes if kind == "all-reduce" else nbytes


def collective_bytes(cfg, shape, rules: dict, mesh_shape: dict,
                     param_leaves=()) -> dict:
    """Wire bytes a device of one step's collectives, by kind (with a
    ``<kind>_count`` beside each), counted from the sharding rules: what
    the rules make each device exchange, not what a compiler emitted.

    Passes: a training step runs each layer's forward, its recompute under
    full remat and its backward (3 passes); serving steps 1. act is one
    stack's residual stream a device, [B / batch shard, tokens, d] in bf16
    (tokens 1 in decode). Counted a step:

    * FSDP over ``data`` (train, ``embed`` on data): every parameter leaf
      with a dim on data, 2 all-gathers (forward; backward and recompute)
      of the leaf gathered over data, and 1 reduce-scatter of its gradient;
    * the data-parallel gradient all-reduce (train): every leaf, 1
      all-reduce of its gradient shard over the batch axes it is not
      sharded on (``pod``; ``data`` where FSDP is off);
    * tensor parallelism over ``model``: each layer's attention (``heads``
      sharded; an encoder-decoder's cross-attention too), dense FFN
      (``ffn``), MoE (``expert_ffn``, or a shared FFN on ``ffn``) and SSM
      (``ssm_in``) sub-block, a pass: with the sequence sharded
      (``act_seq``) 1 all-gather and 1 reduce-scatter of act, else 1
      all-reduce of act;
    * the vocab-parallel embedding (``vocab`` sharded): 1 all-reduce of act
      (a reduce-scatter with ``act_seq``); the vocab-parallel cross-entropy
      (train): 3 all-reduces of fp32 [B, S] (the row max, the sum of
      exponentials, the gold logit) and 1 of the head's input gradient
      (act; with ``act_seq`` an all-gather forward and a reduce-scatter
      back); serving heads leave their logits vocab-sharded;
    * the sequence-sharded decode merge (decode, ``kv_seq`` over more than
      one device): each self-attention layer, 1 all-reduce of its fp32
      partial output, row max and sum, [B, H, dv + 2] (dv the latent rank
      under MLA);
    * the MoE all-to-all (``experts`` sharded): each MoE layer, 2 a pass
      (dispatch and combine) of its [E, C, d] bf16 dispatch tensor a
      device (experts on model, ``moe_cap`` on data).

    ``param_leaves``: (shape, itemsize, spec) of every parameter leaf, for
    the FSDP and gradient terms (train)."""
    out: dict = {}

    def add(kind, nbytes, count=1):
        if count <= 0 or nbytes <= 0:
            return
        out[kind] = out.get(kind, 0) + _wire(kind, nbytes) * count
        out[f"{kind}_count"] = out.get(f"{kind}_count", 0) + count

    msize = mesh_shape.get("model", 1)
    train = shape.kind == "train"
    passes = 3 if train else 1
    bshard = shard_count(rules, mesh_shape, ("batch",))
    Bd = -(-shape.global_batch // bshard)
    d = cfg.d_model
    S = shape.seq_len
    if shape.kind == "decode":
        dec_tokens, enc_tokens = 1, 0
    elif cfg.is_encdec:
        enc_tokens = S // 2
        dec_tokens = S - enc_tokens
    else:
        dec_tokens, enc_tokens = S, 0
    act_seq = rules.get("act_seq") is not None and msize > 1

    def tp(tokens, n_blocks):
        act = Bd * tokens * d * 2
        if act_seq:
            add("all-gather", act, n_blocks * passes)
            add("reduce-scatter", act, n_blocks * passes)
        else:
            add("all-reduce", act, n_blocks * passes)

    if train:
        batch_axes = mesh_axes(rules, ("batch",))
        for shp, isz, spec in param_leaves:
            axes = spec_axes(spec)
            nbytes = math.prod(shp) * isz
            local = nbytes / math.prod(mesh_shape[a] for a in axes) if axes \
                else nbytes
            if "data" in axes and mesh_shape["data"] > 1:
                gathered = local * mesh_shape["data"]
                add("all-gather", gathered, 2)
                add("reduce-scatter", gathered, 1)
            rest = [a for a in batch_axes if a not in axes]
            if rest and math.prod(mesh_shape[a] for a in rest) > 1:
                add("all-reduce", local, 1)

    if msize > 1:
        heads_tp = rules.get("heads") is not None
        blocks = 0
        for i in range(cfg.n_layers):
            if cfg.layer_kind(i) == "attn":
                blocks += heads_tp * (2 if cfg.is_encdec else 1)
            elif rules.get("ssm_in") is not None:
                blocks += 1
            if cfg.family == "ssm":
                continue
            if cfg.layer_is_moe(i):
                shared = cfg.moe.n_shared_experts and rules.get("ffn")
                blocks += bool(rules.get("expert_ffn") is not None or shared)
            else:
                blocks += rules.get("ffn") is not None
        tp(dec_tokens, blocks)
        if cfg.encoder_layers:
            tp(enc_tokens, cfg.encoder_layers * (heads_tp + (rules.get("ffn")
                                                             is not None)))
        if rules.get("vocab") is not None:
            act = Bd * dec_tokens * d * 2
            add("reduce-scatter" if act_seq else "all-reduce", act)
            if train:
                add("all-reduce", Bd * dec_tokens * 4, 3)
                if act_seq:
                    add("all-gather", act)
                    add("reduce-scatter", act)
                else:
                    add("all-reduce", act)

    kv = shard_count(rules, mesh_shape, ("kv_seq",))
    if shape.kind == "decode" and kv > 1:
        dv = cfg.mla.kv_lora_rank if cfg.mla is not None else cfg.head_dim
        add("all-reduce", Bd * cfg.n_heads * (dv + 2) * 4, cfg.n_attn_layers())

    if cfg.moe is not None and rules.get("experts") is not None and msize > 1:
        m = cfg.moe
        C = capacity(shape.global_batch * dec_tokens, m)
        per = m.n_experts * C * d * 2 / shard_count(
            rules, mesh_shape, ("experts", "moe_cap"))
        n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
        add("all-to-all", per, 2 * passes * n_moe)
    return out


# --------------------------------------------------------------------------- #
# The record
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    step: str
    chips: int
    hlo_flops: float  # a device: matmul-class ops + kernel_work
    hlo_bytes: float  # a device: every op's operands and result, unfused
    coll_bytes: float  # a device, from the rules
    coll_breakdown: dict
    model_flops: float  # 6*N*D useful flops, global
    peak_bytes_per_device: int
    arg_bytes_per_device: int

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_fraction(self) -> float:
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(
            t_compute=self.t_compute,
            t_memory=self.t_memory,
            t_collective=self.t_collective,
            bottleneck=self.bottleneck,
            useful_flops_fraction=self.useful_flops_fraction,
        )
        return d


def format_row(r: Roofline) -> str:
    return (
        f"{r.arch:24s} {r.shape:12s} {r.mesh:9s} {r.step:8s} "
        f"t_comp={r.t_compute*1e3:9.3f}ms t_mem={r.t_memory*1e3:9.3f}ms "
        f"t_coll={r.t_collective*1e3:9.3f}ms bound={r.bottleneck:10s} "
        f"useful={r.useful_flops_fraction*100:5.1f}% "
        f"peak_dev={r.peak_bytes_per_device/2**30:6.2f}GiB"
    )


def save(r: Roofline, path):
    with open(path, "w") as f:
        json.dump(r.to_dict(), f, indent=1, default=float)
