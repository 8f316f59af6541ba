"""Mixture-of-Experts block with sort-based (capacity-dropping) dispatch.
Port of ``repro/models/moe.py``: ``_moe_local``, and under a plan the
per-rank body of the reference's ``_moe_sharded``.

Tokens are stably sorted by expert id, ranked within their expert, gathered
into an [E, C, d] buffer (a token past its expert's capacity C is dropped),
run through the experts as batched matrix products over all E banks, and
combined back by a gate-weighted scatter-add; the shared experts see every
token.  The reference runs this outside any Pallas kernel, so it is torch
ops here.  Capacity counts every token of the call, right padding included,
as the reference's does.

Under a plan each rank runs the block on its batch shard's tokens, so the
capacity, the drops and the aux metrics are per shard, as in the
reference's ``shard_map`` body (not the unsharded function): the expert
FFNs are TP over the model axis where ``d_expert`` divides it (partial
sums, reduced once at the end with the shared experts'), the experts EP
over ``ep_axis`` where their count divides it (the [E, C, d] dispatch
buffer goes out by a tiled all-to-all and the results come back by
another), and ``lb_loss`` and ``drop_frac`` are the pmean over the batch
axes.  With the batch replicated (``batch_axes=()``) every rank holds
every token, so the block is the unsharded function, as the reference's
GSPMD path is; its EP all-to-all then carries equal buffers from every
rank (the reference's ``ep_pvary`` case).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import all_to_all, pmean
from repro_torch.models.common import (Dense, activation, randn,
                                      reduce_rows, sharded_axis)
from repro_torch.models.mlp import MLP


class MoE(nn.Module):
    """``router.w`` [d, E] (std 0.02); the expert banks ``up`` and ``gate``
    [E, d, f] (std d^-0.5) and ``down`` [E, f, d] (std f^-0.5), as bare
    parameters; ``shared_{i}`` an MLP of ``d_shared_eff`` units each.  The
    names follow the reference's tree, so a converted one loads as is."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        m = cfg.moe
        d, f = cfg.d_model, m.d_expert
        g = generator
        self.router = Dense(d, m.n_experts, generator=g, dtype=dtype,
                            scale=0.02)

        def bank(*shape, std):
            # scaled in place: the host holds one f32 bank at a time (21.5
            # GB at llama4-maverick's 128 experts of 5120 x 8192)
            return nn.Parameter(randn(*shape, generator=g).mul_(std)
                                .to(dtype), requires_grad=False)
        self.up = bank(m.n_experts, d, f, std=d ** -0.5)
        self.down = bank(m.n_experts, f, d, std=f ** -0.5)
        self.gate = bank(m.n_experts, d, f, std=d ** -0.5) \
            if cfg.gated_mlp else None
        for i in range(m.n_shared_experts):
            setattr(self, f"shared_{i}",
                    MLP(cfg, g, dtype, hidden=m.d_shared_eff))


def route(cfg: ModelConfig, p: MoE, xf: torch.Tensor):
    """Router of tokens xf [T, d]: (probabilities [T, E] in fp32, the top-k
    gates renormalised [T, K], their expert ids [T, K]).  Of two equal
    probabilities the lower expert id ranks first, as ``lax.top_k`` ranks
    them in the reference (``torch.topk`` leaves the order of ties open;
    bf16 router logits tie)."""
    probs = torch.softmax((xf @ p.router.w).float(), dim=-1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    gate_vals, expert_ids = ranked[:, :k], order[:, :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, expert_ids


def router_margin(cfg: ModelConfig, p: MoE, x: torch.Tensor) -> float:
    """The smallest gap, over the tokens of x [..., d], between the k-th and
    the (k+1)-th router probability: how far the inputs are from a tie that
    could flip an expert between two implementations (inf when every
    expert is chosen)."""
    k = cfg.moe.top_k
    if k >= cfg.moe.n_experts:
        return float("inf")
    probs, _, _ = route(cfg, p, x.reshape(-1, x.shape[-1]))
    top = torch.topk(probs, k + 1, dim=-1).values
    return (top[:, k - 1] - top[:, k]).min().item()


def moe_apply(cfg: ModelConfig, p: MoE, x: torch.Tensor, *, plan=None,
              seq_out: bool = False):
    """x: [B, S, d] -> (y [B, S, d], {"lb_loss", "drop_frac"}).  Under
    ``plan`` x is this rank's batch rows and the block runs sharded as the
    module docstring says, its TP and EP axes read from the banks'
    layouts; ``seq_out`` returns y's sequence slice of this rank (a
    sequence-parallel residual)."""
    if plan is None:
        return _moe_local(cfg, p, x)
    tp_axis, ep_axis = sharded_axis(p.up, 2), sharded_axis(p.up, 0)
    for i in range(cfg.moe.n_shared_experts):
        if sharded_axis(getattr(p, f"shared_{i}").down.w, 0) != tp_axis:
            raise ValueError("MoE under a plan: the shared experts' hidden "
                             "units must be sharded as the routed ones'")
    y, aux = _moe_local(cfg, p, x, ep_axis=ep_axis)
    y = reduce_rows(y, plan, tp_axis is not None, seq_out)
    if plan.batch_axes:
        aux = {k: pmean(v, plan.batch_axes) for k, v in aux.items()}
    return y, aux


def expert_capacity(cfg: ModelConfig, tokens: int) -> int:
    """The (token, expert) entries each expert takes in a call over
    ``tokens`` tokens: the mean load times the capacity factor, at least 8
    and at most ``tokens``."""
    m = cfg.moe
    return min(max(8, int(tokens * m.top_k / m.n_experts * m.capacity_factor)),
               tokens)


def _count(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(ids, minlength=n)`` for ids < n, without the host's wait
    for the largest id that ``torch.bincount`` makes on a card."""
    return torch.zeros(n, dtype=ids.dtype, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def _moe_local(cfg: ModelConfig, p: MoE, x: torch.Tensor, *, ep_axis=None):
    """Token-local MoE, in the reference's order: softmax router, top-k,
    capacity over all B·S tokens, stable sort by expert, rank within
    expert, drop past capacity, batched expert MLPs over [E, C, d], gated
    scatter-add back, shared experts on every token.  With ``ep_axis`` the
    banks hold this rank's E/n experts: the buffer is exchanged to
    [E/n, n·C, d] and back.  With banks whose hidden units are sharded the
    output is this rank's partial sum (the caller reduces it)."""
    m = cfg.moe
    b, s, d = x.shape
    t, k, e = b * s, m.top_k, m.n_experts
    xf = x.reshape(t, d)
    probs, gate_vals, expert_ids = route(cfg, p, xf)

    capacity = expert_capacity(cfg, t)

    flat_expert = expert_ids.reshape(-1)                         # [T*K]
    flat_token = torch.arange(t, device=x.device).repeat_interleave(k)
    sorted_expert, order = torch.sort(flat_expert, stable=True)
    sorted_token = flat_token[order]
    sorted_gate = gate_vals.reshape(-1)[order]
    # rank within expert = position - start offset of that expert's run
    counts = _count(sorted_expert, e)                             # [E]
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=x.device) - starts[sorted_expert]
    keep = rank < capacity
    slot = sorted_expert * capacity + torch.where(keep, rank, 0)

    # gather into [E*C, d] (+1 row that takes the dropped entries), so no
    # step waits for the host to count the kept ones
    buf = x.new_zeros((e * capacity + 1, d))
    buf[torch.where(keep, slot, e * capacity)] = xf[sorted_token]
    buf = buf[:-1].reshape(e, capacity, d)
    if ep_axis is not None:
        buf = all_to_all(buf, ep_axis, 0, 1)                      # [E/n, n*C, d]

    up = torch.matmul(buf, p.up)                                  # [E, C, f]
    if p.gate is not None:
        up = activation(cfg, torch.matmul(buf, p.gate)) * up
    else:
        up = activation(cfg, up)
    out_full = torch.matmul(up, p.down)                           # [E, C, d]
    if ep_axis is not None:
        out_full = all_to_all(out_full, ep_axis, 1, 0)
    out_buf = out_full.reshape(-1, d)                             # [E*C, d]

    contrib = torch.where(keep[:, None], out_buf[slot] * sorted_gate[:, None],
                          0)
    y = torch.zeros((t, d), dtype=contrib.dtype, device=x.device)
    y.index_add_(0, sorted_token, contrib)

    for i in range(m.n_shared_experts):
        sp = getattr(p, f"shared_{i}")
        hid = xf @ sp.up.w
        if sp.gate is not None:
            hid = activation(cfg, xf @ sp.gate.w) * hid
        else:
            hid = activation(cfg, hid)
        y = y + hid @ sp.down.w
    y = y.to(x.dtype)

    # aux: load-balance loss (Switch) and the fraction of dropped entries
    me = probs.mean(dim=0)
    ce = _count(expert_ids.reshape(-1), e) / (t * k)
    aux = {"lb_loss": e * torch.sum(me * ce),
           "drop_frac": 1.0 - keep.float().mean()}
    return y.reshape(b, s, d), aux
