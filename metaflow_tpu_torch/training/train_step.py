"""Training on one GPU: the AdamW optimizer of the JAX package, the train
state, and the train and eval steps.

`default_optimizer` is optax's `chain(clip_by_global_norm, adamw)` on a
`warmup_cosine_decay_schedule`, written as plain functions on tensors:
`mu` is kept in `mu_dtype` (f32) and `nu` in the parameter's dtype, as
optax's `scale_by_adam` keeps them, and the parameters are updated in
their own dtype. A step updates the parameters and the moments in place,
the port's counterpart of the JAX step donating its state.

Parameters are the model's plain dict of tensors (`init_params` or
`from_jax_params` output). Leaves are visited in the JAX package's tree
order (sorted keys), so sums over leaves add in the same order.
"""

import math
from dataclasses import dataclass

import torch

from ..models.llama import resolve_device


def _lr_schedule(lr, warmup_steps, total_steps):
    """optax.warmup_cosine_decay_schedule(0, lr, warmup_steps,
    max(total_steps, warmup_steps + 1), end_value=lr / 10): the learning
    rate for an update count. Linear from 0 over the warmup, then a cosine
    down to a tenth of the peak. An update reads it at its count before the
    increment, so the first update has learning rate 0."""
    decay_steps = max(total_steps, warmup_steps + 1)
    alpha = 0.0 if lr == 0 else 0.1
    span = decay_steps - warmup_steps

    def schedule(count):
        if count < warmup_steps:
            return lr * count / warmup_steps
        t = min(count - warmup_steps, span)
        cosine = 0.5 * (1 + math.cos(math.pi * t / span))
        return lr * ((1 - alpha) * cosine + alpha)

    return schedule


def leaves(tree, prefix=()):
    """(path, tensor) pairs of a nested dict in sorted-key order, the
    order of jax.tree.leaves."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def global_norm(tensors):
    """optax.global_norm: the square root of the summed squares of every
    tensor, in f32."""
    total = None
    for t in tensors:
        sq = t.float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@dataclass(frozen=True)
class AdamW:
    """clip_by_global_norm(clip_norm), then AdamW (b1, b2, eps outside the
    square root, bias correction on the incremented count, decoupled decay
    lr * weight_decay * p), on `schedule`. `init` builds the state,
    `update` applies one step in place."""

    schedule: object
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    mu_dtype: torch.dtype = torch.float32

    def init(self, params):
        """{'count': 0, 'mu': zeros in mu_dtype, 'nu': zeros in each
        parameter's dtype}, on the parameters' device."""
        return {"count": 0,
                "mu": _map(lambda p: torch.zeros_like(p, dtype=self.mu_dtype),
                           params),
                "nu": _map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, params, grads, state):
        """One step on params (a dict of tensors) with grads (the same
        tree), in place. Returns the global norm of the unclipped grads.

        optax's arithmetic in its order: clip (g unchanged when the norm is
        below clip_norm, else g / norm * clip_norm); mu = (1 - b1) g + b1 mu;
        nu = (1 - b2) g^2 + b2 nu; u = (mu / (1 - b1^t)) /
        (sqrt(nu / (1 - b2^t)) + eps) + weight_decay p; p = p - lr u, with t
        the incremented count and lr the schedule at the count before it.
        The intermediates are f32, the stored moments and parameters are
        rounded to their dtypes once, as XLA's fused update keeps excess
        precision between the stored values."""
        pairs = list(zip(leaves(params), leaves(grads), leaves(state["mu"]),
                         leaves(state["nu"])))
        for (path, _), (gpath, _), (mpath, _), (npath, _) in pairs:
            if not path == gpath == mpath == npath:
                raise ValueError("params, grads and optimizer state differ "
                                 "in structure at %s" % "/".join(path))
        norm = global_norm(g for _, (_, g), _, _ in pairs)
        trigger = norm < self.clip_norm
        count = state["count"] + 1
        lr = self.schedule(state["count"])
        bc1 = 1 - self.b1 ** count
        bc2 = 1 - self.b2 ** count
        for (_, p), (_, g), (_, mu), (_, nu) in pairs:
            g = g.float()
            g = torch.where(trigger, g, g / norm * self.clip_norm)
            mu_new = (1 - self.b1) * g + self.b1 * mu.float()
            nu_new = (1 - self.b2) * (g * g) + self.b2 * nu.float()
            mu.copy_(mu_new)
            nu.copy_(nu_new)
            u = (mu_new / bc1) / (torch.sqrt(nu.float() / bc2) + self.eps)
            u = u + self.weight_decay * p.float()
            p.copy_(p.float() + (-lr) * u)
        state["count"] = count
        return norm


def default_optimizer(lr=3e-4, weight_decay=0.1, clip_norm=1.0,
                      warmup_steps=100, total_steps=10_000, b1=0.9, b2=0.95,
                      mu_dtype=torch.float32):
    return AdamW(schedule=_lr_schedule(lr, warmup_steps, total_steps), b1=b1,
                 b2=b2, weight_decay=weight_decay, clip_norm=clip_norm,
                 mu_dtype=mu_dtype)


def check_opt_state(optimizer, state):
    """Guard: would `optimizer.init(state['params'])` build this opt state?

    A state built by one optimizer and stepped by another with other
    hyperparameters is silently wrong when the trees line up. The check
    builds the state `optimizer.init` would build on the meta device (no
    memory) and compares keys, shapes and dtypes with state['opt_state'];
    it raises a ValueError that names the mismatch."""
    meta = _map(lambda p: torch.empty_like(p, device="meta"),
                state["params"])
    expect = optimizer.init(meta)
    got = state["opt_state"]
    if set(expect) != set(got):
        raise ValueError(
            "optimizer/opt_state mismatch: optimizer.init(params) would "
            "build keys %s but state['opt_state'] has %s; make_train_state "
            "and make_train_step must share ONE optimizer (use make_trainer)"
            % (sorted(expect), sorted(got)))
    for name in ("mu", "nu"):
        want = dict(leaves(expect[name]))
        have = dict(leaves(got[name]))
        if set(want) != set(have):
            raise ValueError(
                "optimizer/opt_state mismatch: opt_state[%r] has leaves %s, "
                "optimizer.init(params) would build %s"
                % (name, sorted(have), sorted(want)))
        for path, w in want.items():
            h = have[path]
            if tuple(w.shape) != tuple(h.shape) or w.dtype != h.dtype:
                raise ValueError(
                    "optimizer/opt_state mismatch at opt_state[%r]/%s: "
                    "optimizer.init(params) would build %s%s, state has "
                    "%s%s (same optimizer family, other mu_dtype?)"
                    % (name, "/".join(path), w.dtype, tuple(w.shape),
                       h.dtype, tuple(h.shape)))


def make_train_state(cfg, model, optimizer=None, params=None, generator=None,
                     device="cuda"):
    """{'params', 'opt_state', 'step'} on `device`. `params` starts from
    given weights (e.g. from_jax_params output, which must live on
    `device`); otherwise model.init_params(cfg, generator, device). The
    parameters are made leaves that require grad."""
    device = resolve_device(device)
    optimizer = optimizer or default_optimizer()
    if params is None:
        params = model.init_params(cfg, generator, device=device)
    model.check_params_device(params, device)
    for _, p in leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt_state": optimizer.init(params),
            "step": 0}


def make_train_step(cfg, model, optimizer=None, loss_fn=None, device="cuda"):
    """The train step: (state, batch) -> (state, {'loss', 'grad_norm'}),
    both 0-dim f32 tensors on the device. The step updates the state's
    parameters and moments in place and returns the same dict.

    `optimizer` must be the one the state was built with; make_trainer
    shares one and checks it."""
    device = resolve_device(device)
    optimizer = optimizer or default_optimizer()
    loss_fn = loss_fn or model.loss_fn

    def step(state, batch):
        params = state["params"]
        for _, p in leaves(params):
            p.grad = None
        loss = loss_fn(params, batch, cfg, device=device)
        loss.backward()
        grads = _map(lambda p: p.grad, params)
        grad_norm = optimizer.update(params, grads, state["opt_state"])
        for _, p in leaves(params):
            p.grad = None
        state["step"] += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step


def make_trainer(cfg, model, optimizer=None, loss_fn=None, params=None,
                 generator=None, device="cuda"):
    """One-stop builder: (state, train_step) sharing a SINGLE optimizer,
    with check_opt_state run on the built state. Starts from `params` when
    given (see make_train_state)."""
    optimizer = optimizer or default_optimizer()
    state = make_train_state(cfg, model, optimizer=optimizer, params=params,
                             generator=generator, device=device)
    step = make_train_step(cfg, model, optimizer=optimizer, loss_fn=loss_fn,
                           device=device)
    check_opt_state(optimizer, state)
    return state, step


def make_eval_step(cfg, model, loss_fn=None, device="cuda"):
    """(params, batch) -> loss, without gradients."""
    device = resolve_device(device)
    loss_fn = loss_fn or model.loss_fn

    @torch.no_grad()
    def step(params, batch):
        return loss_fn(params, batch, cfg, device=device)

    return step
