"""Mixture-of-Experts: top-k router + capacity-based gather/scatter dispatch.

The counterpart of the JAX package's ``models/moe.py``, with its semantics
kept exactly: GShard/Switch-style slot positions from a sequential cumsum
over the K choices (row-major over the T rows the call carries, k-major
across a token's choices), a capacity C from T (pad rows count), tokens
past C dropped, and the combine summed k = 0..K-1 in the activation dtype.
Every shape is fixed by T on the host and nothing reads a device value
back (no ``.item()``, ``nonzero()`` or boolean-mask indexing), so a decode
step with MoE layers captures into a CUDA graph.

The expert products are plain batched matrix products over the experts
(``torch.bmm`` on the card, as JAX's ``einsum`` outside any Pallas kernel);
a decode step runs all E experts on their C >= 8 slots each, so it reads
every expert's weights, as the JAX model does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.schema import ParamSpec


def moe_schema(cfg) -> dict:
    d = cfg.d_model
    m = cfg.moe
    s = {
        "router": ParamSpec((d, m.n_experts), init="small_normal"),
        "w_gate": ParamSpec((m.n_experts, d, m.d_ff)),
        "w_up": ParamSpec((m.n_experts, d, m.d_ff)),
        "w_down": ParamSpec((m.n_experts, m.d_ff, d)),
    }
    if m.n_shared_experts:
        ff = m.n_shared_experts * m.d_ff
        s["shared"] = {
            "w_gate": ParamSpec((d, ff)),
            "w_up": ParamSpec((d, ff)),
            "w_down": ParamSpec((ff, d)),
        }
    return s


def capacity(n_tokens: int, cfg_moe) -> int:
    """Slots an expert takes for ``n_tokens`` rows: at least 8, rounded up
    to a multiple of 8."""
    c = math.ceil(n_tokens * cfg_moe.top_k * cfg_moe.capacity_factor
                  / cfg_moe.n_experts)
    return max(8, ((c + 7) // 8) * 8)


def router_topk(logits, top_k: int):
    """fp32 softmax, then top-k, then the k weights renormalised (the sum
    clamped at 1e-9): returns (weights [T, K] fp32, ids [T, K] int64).

    Equal probabilities (equal router logits, frequent in bf16) keep the
    lower expert first, as ``jax.lax.top_k`` does: a stable descending
    sort, where ``torch.topk`` leaves the order of ties unspecified."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :top_k], ids[:, :top_k]
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    return w, ids


def load_balance_loss(logits, ids, n_experts: int):
    """Switch-style aux loss: E * sum_e f_e * p_e (fp32 scalar)."""
    probs = torch.softmax(logits.float(), dim=-1)
    p_mean = probs.reshape(-1, n_experts).mean(dim=0)
    experts = torch.arange(n_experts, device=ids.device)
    onehot = (ids.reshape(-1)[:, None] == experts).float()
    f_mean = onehot.mean(dim=0) * ids.shape[-1]
    return n_experts * torch.sum(p_mean * f_mean)


def dispatch_plan(ids, n_experts: int, C: int):
    """Slot of every (token, choice): (pos [T, K] int64, keep [T, K] bool,
    slot_tok [E, C] int64 with T marking an empty slot).

    Choice k's positions continue where choice k-1's counts left off (the
    JAX package's per-k cumsum), so the first choices of every token fill
    an expert before any second choice does. Dropped choices scatter into
    an overflow column C that is then cut off."""
    T, K = ids.shape
    dev = ids.device
    pos_list, keep_list = [], []
    counts = torch.zeros((n_experts,), dtype=torch.int64, device=dev)
    experts = torch.arange(n_experts, device=dev)
    for k in range(K):
        onehot = (ids[:, k, None] == experts).to(torch.int64)  # [T, E]
        pos_in_e = torch.cumsum(onehot, dim=0) - 1 + counts[None, :]
        pos_k = (pos_in_e * onehot).sum(dim=-1)  # [T]
        counts = counts + onehot.sum(dim=0)
        keep_list.append(pos_k < C)
        pos_list.append(pos_k)
    pos = torch.stack(pos_list, dim=1)
    keep = torch.stack(keep_list, dim=1)
    flat_pos = torch.where(keep, pos, torch.full_like(pos, C)).reshape(-1)
    tok_ids = torch.arange(T, device=dev)[:, None].expand(T, K).reshape(-1)
    slot_tok = torch.full((n_experts, C + 1), T, dtype=torch.int64, device=dev)
    # each kept (expert, slot) pair is unique; every drop lands in column C
    slot_tok.index_put_((ids.reshape(-1), flat_pos), tok_ids)
    return pos, keep, slot_tok[:, :C]


def route(p, cfg, x2d):
    """The router half of the layer for x2d [T, d]: (weights [T, K], ids
    [T, K], aux, pos [T, K], keep [T, K], slot_tok [E, C]), C from T. The
    router logits are in the activation dtype, as in JAX."""
    m = cfg.moe
    logits = x2d @ p["router"].to(x2d.dtype)  # [T, E]
    weights, ids = router_topk(logits, m.top_k)
    aux = load_balance_loss(logits, ids, m.n_experts)
    pos, keep, slot_tok = dispatch_plan(ids, m.n_experts,
                                        capacity(x2d.shape[0], m))
    return weights, ids, aux, pos, keep, slot_tok


def gather_tokens(x2d, slot_tok):
    """[E, C, d] expert inputs: each slot's token row, zero where empty
    (an empty slot reads row T-1, then is zeroed)."""
    T = x2d.shape[0]
    xe = x2d[torch.clamp(slot_tok, max=T - 1)]
    return xe.masked_fill((slot_tok >= T)[..., None], 0)


def expert_ffn(p, xe):
    """The three expert products batched over experts: xe [E, C, d] ->
    [E, C, d]."""
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    return torch.bmm(h, p["w_down"])


def combine(ye, weights, ids, pos, keep, dtype):
    """Each token's K expert outputs read back from ye [E, C, d], weighted
    by ``weights * keep`` in the activation dtype and summed k = 0..K-1 in
    that order (a dropped choice reads a clamped slot and weighs 0)."""
    C = ye.shape[1]
    T, K = ids.shape
    out = torch.zeros((T, ye.shape[2]), dtype=dtype, device=ye.device)
    for k in range(K):
        val = ye[ids[:, k], torch.clamp(pos[:, k], max=C - 1)]  # [T, d]
        w_k = (weights[:, k] * keep[:, k]).to(dtype)
        out = out + val * w_k[:, None]
    return out


def moe_apply(p, cfg, x2d):
    """x2d: [T, d] -> ([T, d], aux_loss). Capacity-dropping top-k dispatch
    over the T rows given (pad rows included, as in JAX)."""
    weights, ids, aux, pos, keep, slot_tok = route(p, cfg, x2d)
    ye = expert_ffn(p, gather_tokens(x2d, slot_tok))  # [E, C, d]
    out = combine(ye, weights, ids, pos, keep, x2d.dtype)
    if cfg.moe.n_shared_experts:
        sp = p["shared"]
        hs = F.silu(x2d @ sp["w_gate"]) * (x2d @ sp["w_up"])
        out = out + hs @ sp["w_down"]
    return out, aux
