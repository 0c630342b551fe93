"""Mixture-of-Experts: top-k router and three dispatch strategies.

``gmm`` (the training path): DROPLESS dispatch through the grouped
    matmul (ops/gmm.py, kernels K5 and K6): slots sort into
    expert-contiguous 128-row tiles and each tile multiplies its expert's
    weights. Exact top-k semantics, no capacity, no drops.
``sparse`` (the config's default, and what decoding uses):
    capacity-bucketed dispatch into static [experts, capacity, embed]
    buffers; with capacity_factor None it is lossless.
``dense``: every expert sees every token through one-hot products; the
    oracle of the other two.

Capacity semantics are the JAX package's: an expert accepts its first
``capacity`` tokens in token order, the rest are dropped (their combine
weight becomes 0). ``gmm_ep`` and an explicit ``mesh`` need an expert mesh
across GPUs, which the port does not have yet: they raise.
"""

import math

import torch
import torch.nn.functional as F

from .matmul import matmul_f32
from .gmm import gather_rows, gmm, make_group_layout, scatter_rows

_NOT_PORTED = ("dispatch='gmm_ep' and expert meshes need expert parallelism "
               "across GPUs, which is not ported yet (ROADMAP.md, slice 5, "
               "multi-GPU: gmm_ep)")


def top_k_router(logits, num_experts, k, dtype=torch.float32):
    """logits: [tokens, experts] -> (weights [tokens, k], idx [tokens, k]).

    Softmax over the selected k (Mixtral convention), in f32, cast to
    `dtype`."""
    gate_logits, idx = torch.topk(logits, k, dim=-1)
    weights = torch.softmax(gate_logits.float(), dim=-1)
    return weights.to(dtype), idx


def expert_capacity(num_tokens, num_experts, k, capacity_factor):
    """Static per-expert token budget; capacity_factor None means lossless
    (capacity = num_tokens)."""
    if capacity_factor is None:
        return num_tokens
    cap = int(math.ceil(capacity_factor * num_tokens * k / num_experts))
    return max(1, min(cap, num_tokens))


def moe_ffn(x, router_w, w_gate, w_up, w_down, num_experts_per_tok=2,
            capacity_factor=None, activation=F.silu, dispatch="sparse",
            mesh=None, ep_buffer_factor=None):
    """Token-choice MoE feed-forward.

    x: [B, S, E]; router_w: [E, num_experts]; w_gate, w_up:
    [num_experts, E, F]; w_down: [num_experts, F, E].
    Returns (out [B, S, E], aux_loss scalar f32).
    """
    if dispatch == "gmm_ep" or mesh is not None:
        raise NotImplementedError(_NOT_PORTED)
    if ep_buffer_factor is not None:
        raise ValueError("ep_buffer_factor only applies to dispatch='gmm_ep'")
    B, S, E = x.shape
    num_experts = router_w.shape[1]
    k = num_experts_per_tok
    tokens = x.reshape(B * S, E)

    router_logits = tokens.float() @ router_w.float()
    weights, idx = top_k_router(router_logits, num_experts, k, dtype=x.dtype)
    one_hot = F.one_hot(idx, num_experts).to(x.dtype)  # [t, k, n]
    aux = _load_balancing_loss(router_logits, one_hot)

    if dispatch == "sparse":
        out = _sparse_dispatch_ffn(tokens, weights, idx, w_gate, w_up,
                                   w_down, num_experts, k, capacity_factor,
                                   activation)
    elif dispatch == "dense":
        out = _dense_dispatch_ffn(tokens, weights, idx, one_hot, w_gate,
                                  w_up, w_down, num_experts, k,
                                  capacity_factor, activation)
    elif dispatch == "gmm":
        if capacity_factor is not None:
            raise ValueError(
                "dispatch='gmm' is dropless — capacity_factor must be None")
        out = _gmm_dispatch_ffn(tokens, weights, idx, w_gate, w_up, w_down,
                                num_experts, k, activation)
    else:
        raise ValueError("dispatch must be 'sparse', 'dense', 'gmm' or "
                         "'gmm_ep', got %r" % (dispatch,))
    return out.reshape(B, S, E), aux


def _expert_matmul_f32(a, w):
    """Per-expert a[n] @ w[n] with f32 products, sums and result (the JAX
    package's preferred_element_type=float32): a [N, C, E], w [N, E, F]."""
    return torch.stack([matmul_f32(a[n], w[n]) for n in range(w.shape[0])])


def _sparse_dispatch_ffn(tokens, weights, idx, w_gate, w_up, w_down,
                         num_experts, k, capacity_factor, activation):
    """Capacity-bucketed dispatch. Slot order is token-major, so each
    expert's arrival order is token order: the dense oracle's drops."""
    T, E = tokens.shape
    N = num_experts
    C = expert_capacity(T, N, k, capacity_factor)

    e_flat = idx.reshape(T * k)
    w_flat = weights.reshape(T * k)
    slot_one_hot = F.one_hot(e_flat, N)                   # [T*k, N]
    pos = torch.cumsum(slot_one_hot, dim=0) - 1
    pos_flat = pos.gather(1, e_flat[:, None])[:, 0]
    keep = pos_flat < C
    # dropped slots land in an extra row C that is cut off (the JAX
    # scatter's mode="drop"); positions are unique per expert
    safe_pos = torch.where(keep, pos_flat, C)
    t_flat = torch.arange(T * k, device=tokens.device) // k

    x_buf = tokens.new_zeros((N, C + 1, E)).index_put(
        (e_flat, safe_pos), tokens[t_flat], accumulate=True)[:, :C]

    gate = activation(_expert_matmul_f32(x_buf, w_gate))
    up = _expert_matmul_f32(x_buf, w_up)
    y_buf = _expert_matmul_f32((gate * up).to(tokens.dtype), w_down)
    y_buf = y_buf.to(tokens.dtype)

    # out-of-range gathers clamp, as JAX's do, and are zeroed by keep
    y_slots = y_buf[e_flat, safe_pos.clamp(max=C - 1)]
    y_slots = torch.where(keep[:, None], y_slots, 0) * w_flat[:, None]
    return y_slots.reshape(T, k, E).sum(dim=1)


def _gmm_dispatch_ffn(tokens, weights, idx, w_gate, w_up, w_down,
                      num_experts, k, activation):
    """Dropless dispatch through the grouped matmul: sort slots into
    expert-contiguous 128-row tiles, run the three expert products as gmm
    (bf16 outputs; the activation and gate * up in the activation dtype),
    gather and combine in the activation dtype."""
    T, E = tokens.shape
    e_flat = idx.reshape(T * k)
    w_flat = weights.reshape(T * k)
    t_flat = torch.arange(T * k, device=tokens.device) // k

    layout = make_group_layout(e_flat, num_experts)
    x_pad = scatter_rows(tokens[t_flat], layout)
    tg, ta = layout["tile_group"], layout["tile_active"]
    gate = activation(gmm(x_pad, w_gate, tg, tile_active=ta))
    up = gmm(x_pad, w_up, tg, tile_active=ta)
    y_pad = gmm((gate * up).to(tokens.dtype), w_down, tg, tile_active=ta)
    y_slots = gather_rows(y_pad, layout) * w_flat[:, None]
    return y_slots.reshape(T, k, E).sum(dim=1)


def _dense_dispatch_ffn(tokens, weights, idx, one_hot, w_gate, w_up, w_down,
                        num_experts, k, capacity_factor, activation):
    """Reference oracle: every expert sees every token (one-hot
    products)."""
    T, E = tokens.shape
    # combine matrix: [tokens, experts], rows sum to 1 over the selected
    combine = torch.einsum("tkn,tk->tn", one_hot, weights)

    if capacity_factor is not None:
        C = expert_capacity(T, num_experts, k, capacity_factor)
        # capacity counts the routing mask, not combine > 0: a slot whose
        # weight underflowed to 0 still holds a place, as in sparse
        dispatch_mask = one_hot.sum(dim=1) > 0               # [t, n]
        position = torch.cumsum(dispatch_mask.long(), dim=0) * dispatch_mask
        combine = torch.where(position <= C, combine, 0.0)

    # [n, t, E]: per-expert token batch
    h = torch.einsum("te,tn->nte", tokens, (combine != 0).to(tokens.dtype))
    gate = activation(_expert_matmul_f32(h, w_gate))
    up = _expert_matmul_f32(h, w_up)
    expert_out = _expert_matmul_f32((gate * up).to(tokens.dtype), w_down)
    return torch.einsum("nte,tn->te", expert_out.to(tokens.dtype), combine)


def _load_balancing_loss(router_logits, one_hot):
    """Switch-style auxiliary loss: num_experts * sum_i fraction_i * prob_i.
    fraction is in the one-hot's dtype (the activation dtype), as the JAX
    package's mean leaves it, before the f32 product."""
    num_experts = router_logits.shape[-1]
    probs = torch.softmax(router_logits, dim=-1)
    fraction = one_hot.sum(dim=1).float().mean(dim=0).to(one_hot.dtype)
    prob_mean = probs.mean(dim=0)
    return num_experts * torch.sum(fraction.float() * prob_mean)
