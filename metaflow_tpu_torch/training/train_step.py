"""Training on one GPU: the JAX package's two optimizers, the train state,
and the train and eval steps.

`default_optimizer` is optax's `chain(clip_by_global_norm, adamw)` on a
`warmup_cosine_decay_schedule`, written as plain functions on tensors:
`mu` is kept in `mu_dtype` (f32) and `nu` in the parameter's dtype, as
optax's `scale_by_adam` keeps them, and the parameters are updated in
their own dtype. `memory_efficient_optimizer` is the reference's factored
Adafactor (bf16 momentum, factored second moment, decoupled decay), the
one its benchmark takes on an accelerator. A step updates the parameters
and the optimizer state in place, the port's counterpart of the JAX step
donating its state.

Parameters are the model's plain dict of tensors (`init_params` or
`from_jax_params` output). Leaves are visited in the JAX package's tree
order (sorted keys), so sums over leaves add in the same order.
"""

import functools
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import knobs
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


def _bf16(x):
    """x rounded to bf16 (nearest even) and held in f32: one rounding of
    the reference's bf16 program."""
    return x.to(torch.bfloat16).float()


@functools.lru_cache(maxsize=64)
def _as_bf16(value):
    """A Python constant as the bf16 literal JAX makes of it when it
    meets a bf16 operand (a weak-typed scalar), as a float."""
    return float(torch.tensor(value, dtype=torch.float32).to(torch.bfloat16))


def global_norm(tensors):
    """optax.global_norm: the square root of the summed squares of every
    tensor, as an f32 tensor. For f32 tensors the sums are f32 throughout.
    For bf16 tensors it is what the reference's jitted program computes:
    each tensor's squares summed in f32 and the sum rounded to bf16, the
    tensors' sums added one by one in bf16, the square root rounded to
    bf16. The tensors share one dtype."""
    total, dtype = None, None
    for t in tensors:
        if dtype is not None and t.dtype != dtype:
            raise ValueError("global_norm: tensors of dtypes %s and %s"
                             % (dtype, t.dtype))
        dtype = t.dtype
        sq = t.float().square().sum()
        if dtype == torch.bfloat16:
            sq = _bf16(sq)
            total = sq if total is None else _bf16(total + sq)
        else:
            total = sq if total is None else total + sq
    norm = torch.sqrt(total)
    return _bf16(norm) if dtype == torch.bfloat16 else norm


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

        f32 grads: the intermediates are f32 and the stored moments and
        parameters are rounded to their dtypes once.

        bf16 grads: the reference runs the chain inside one jitted step,
        where JAX turns each Python constant that meets a bf16 operand into
        a bf16 literal (1 - b1 = 0.10009765625, 1 - b2 = 0.050048828125,
        b2 = 0.94921875, eps, weight_decay, clip_norm; b1 stays f32 beside
        the f32 mu) and each bf16 op rounds to bf16. XLA's CPU program, read
        from its optimised HLO, computes the ops in f32 and keeps the bf16
        roundings of the norm (global_norm), of g / norm, of g^2,
        (1 - b2) g^2, b2 nu and their sum (the stored nu), of
        nu / bf16(1 - b2^t) and of its square root. It drops three: the
        products (1 - b1) g and weight_decay p, and sqrt(.) + eps, enter the
        next f32 op unrounded (excess precision where the program converts
        a bf16 result to f32). It also rewrites (mu / bc1) / d as
        mu / (bc1 d). This update makes the same roundings in the same
        order, so parameters and nu come out bit for bit and mu within f32
        rounding (tests/test_torch_train.py)."""
        pairs = list(zip(leaves(params), leaves(grads), leaves(state["mu"]),
                         leaves(state["nu"])))
        for (path, _), (gpath, _), (mpath, _), (npath, _) in pairs:
            if not path == gpath == mpath == npath:
                raise ValueError("params, grads and optimizer state differ "
                                 "in structure at %s" % "/".join(path))
        norm = global_norm(g for _, (_, g), _, _ in pairs)
        low = bool(pairs) and pairs[0][1][1].dtype == torch.bfloat16
        trigger = norm < (_as_bf16(self.clip_norm) if low else self.clip_norm)
        count = state["count"] + 1
        lr = self.schedule(state["count"])
        bc1 = 1 - self.b1 ** count
        bc2 = 1 - self.b2 ** count
        for (_, leaf), (_, grad), (_, m), (_, v) in pairs:
            for p, g, mu, nu in _update_chunks(leaf, grad, m, v):
                if low:
                    self._update_bf16(p, g, mu, nu, norm, trigger, lr, bc1,
                                      bc2)
                    continue
                g = g.float()
                g = torch.where(trigger, g, g / norm * self.clip_norm)
                mu_new = (1 - self.b1) * g + self.b1 * mu.float()
                nu_new = (1 - self.b2) * (g * g) + self.b2 * nu.float()
                mu.copy_(mu_new)
                nu.copy_(nu_new)
                u = (mu_new / bc1) / (torch.sqrt(nu.float() / bc2)
                                      + self.eps)
                u = u + self.weight_decay * p.float()
                p.copy_(p.float() + (-lr) * u)
        state["count"] = count
        return norm

    def _update_bf16(self, p, g, mu, nu, norm, trigger, lr, bc1, bc2):
        """One chunk of update() for bf16 grads, rounding where the
        reference's jitted program rounds (see update); norm is the bf16
        global norm, trigger whether it is below the bf16 clip_norm. An op
        on bf16 tensors computes in f32 and rounds its result to bf16 once,
        which is each of those roundings; the unrounded steps run on f32
        tensors."""
        g = torch.where(trigger, g,
                        g / norm.to(g.dtype) * _as_bf16(self.clip_norm))
        gc = g.float()
        mu.mul_(self.b1).add_(gc.mul_(_as_bf16(1 - self.b1)))
        nu.mul_(_as_bf16(self.b2)).add_(g.mul(g).mul_(_as_bf16(1 - self.b2)))
        den = torch.sqrt(nu / _as_bf16(bc2)).float()
        den.add_(_as_bf16(self.eps)).mul_(bc1)
        pf = p.float()
        u = mu / den
        u.add_(pf * _as_bf16(self.weight_decay))
        p.copy_(pf.add_(u.mul_(-lr)))


# elements of one leaf that an AdamW update works on at once: the f32
# temporaries of a stacked expert weight (Mixtral-8x7B's w_gate at two
# layers, [2, 8, 4096, 14336], is 3.8 GB per temporary) are held to 256 MB
# each
UPDATE_CHUNK = 1 << 26


def _update_chunks(*tensors):
    """The leaf's (param, grad, mu, nu) as flat views of at most
    UPDATE_CHUNK elements each; a smaller leaf gives one. The update is
    elementwise, so its result does not depend on the split. Every leaf is
    contiguous: the parameters and moments are made so, and autograd gives
    a grad its parameter's strides (view raises otherwise)."""
    flat = [t.view(-1) for t in tensors]
    for start in range(0, flat[0].numel(), UPDATE_CHUNK):
        yield tuple(t[start:start + UPDATE_CHUNK] for t in flat)


def default_optimizer(lr=3e-4, weight_decay=0.1, clip_norm=1.0,
                      warmup_steps=100, total_steps=10_000, b1=0.9, b2=0.95,
                      mu_dtype=torch.float32):
    return AdamW(schedule=_lr_schedule(lr, warmup_steps, total_steps), b1=b1,
                 b2=b2, weight_decay=weight_decay, clip_norm=clip_norm,
                 mu_dtype=mu_dtype)


def memory_efficient_optimizer(lr=3e-4, weight_decay=0.1, clip_norm=1.0,
                               warmup_steps=100, total_steps=10_000, b1=0.9):
    """The JAX package's memory_efficient_optimizer (Adafactor, bf16 first
    moment, factored second moment, decoupled decay), on the same
    warmup-cosine schedule as default_optimizer."""
    return Adafactor(schedule=_lr_schedule(lr, warmup_steps, total_steps),
                     b1=b1, weight_decay=weight_decay, clip_norm=clip_norm)


# optax.adafactor's defaults, which the reference keeps: the second
# moment's decay b2_t = 1 - (t+1)^-0.8, the eps added to g^2, and the
# least size of the two axes a leaf's second moment is factored over
FACTORED_DECAY_RATE = 0.8
FACTORED_EPS = 1e-30
MIN_DIM_SIZE_TO_FACTOR = 128


def factored_dims(shape):
    """optax's _factored_dims: (d1, d0), the second largest and the largest
    axis of `shape` by np.argsort (not the last two), over which the second
    moment is factored; None when the leaf has fewer than two axes or its
    second largest is below MIN_DIM_SIZE_TO_FACTOR. A stacked [L, D, F]
    layer leaf is factored over (D, F) and keeps L; an [L, D] norm with
    L < 128 is not factored."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def _without(shape, axis):
    return tuple(n for i, n in enumerate(shape) if i != axis)


@dataclass(frozen=True)
class Adafactor:
    """The JAX package's memory_efficient_optimizer: clip_by_global_norm,
    then optax.adafactor without parameter scaling or update clipping,
    with a bf16 first moment, and decoupled weight decay on the scheduled
    learning rate. About 2 bytes of state a parameter (the momentum) where
    AdamW keeps 8. `init` builds the state, `update` applies one step in
    place."""

    schedule: object
    b1: float = 0.9
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params):
        """{'count': 0, 'v_row', 'v_col', 'v': optax's factored state in
        each parameter's dtype (a factored leaf keeps v_row, the mean over
        its largest axis, and v_col, the mean over its second largest; the
        others keep v; each unused slot is a zero of shape (1,), as optax
        keeps it), 'mu': bf16 zeros}, on the parameters' device."""

        def slot(p, which):
            dims = factored_dims(tuple(p.shape))
            if dims is None:
                shape = tuple(p.shape) if which == "v" else (1,)
            elif which == "v":
                shape = (1,)
            else:
                shape = _without(p.shape, dims[1] if which == "v_row"
                                 else dims[0])
            return torch.zeros(shape, dtype=p.dtype, device=p.device)

        state = {"count": 0}
        for which in ("v_row", "v_col", "v"):
            state[which] = _map(functools.partial(slot, which=which), params)
        state["mu"] = _map(
            lambda p: torch.zeros_like(p, dtype=torch.bfloat16), params)
        return state

    @torch.no_grad()
    def update(self, params, grads, state):
        """One step on params with grads (the same tree), in place. Returns
        the global norm of the unclipped grads.

        optax's chain in its order: clip by the global norm; scale by the
        factored rms (b2_t = 1 - (t+1)^-0.8 on the count t before the
        increment, eps added to g^2; a factored leaf's update is
        g * (v_row / mean(v_row))^-0.5 * v_col^-0.5 with the two means
        broadcast back over the axes they were taken on, any other
        g * v^-0.5); scale by the learning rate at t; the first moment
        mu = (1 - b1) u + b1 mu, whose f32 value is the update and whose
        bf16 rounding is stored; negate; then the decoupled
        -lr(t) * weight_decay * p; p + u rounded to p's dtype.

        Every op computes in its operands' dtype as JAX computes it: on
        bf16 leaves each bf16 product, quotient, sum and power is rounded
        to bf16, with a Python constant that meets a bf16 operand taken as
        its bf16 literal (the learning rate too), and the means summed in
        f32; b2_t and 1 - b2_t stay f32, and lr(t) * weight_decay is an f32
        scalar that JAX types weakly, so beside a bf16 parameter it is
        rounded to bf16 and so is its product with the parameter (read
        from the jitted step's HLO). The leaves' temporaries are held to
        UPDATE_CHUNK elements: a factored leaf is walked one [rows, cols]
        slice of its kept axes at a time and each slice in row chunks, the
        column sums accumulated in f32 across them."""
        pairs = list(zip(leaves(params), leaves(grads),
                         *(leaves(state[k]) for k in ("v_row", "v_col", "v",
                                                      "mu"))))
        for item in pairs:
            paths = [path for path, _ in item]
            if any(path != paths[0] for path in paths):
                raise ValueError("params, grads and optimizer state differ "
                                 "in structure at %s" % "/".join(paths[0]))
        norm = global_norm(g for _, (_, g), *_ in pairs)
        low = bool(pairs) and pairs[0][1][1].dtype == torch.bfloat16
        trigger = norm < (_as_bf16(self.clip_norm) if low
                          else self.clip_norm)
        count = state["count"]
        f32 = np.float32
        decay = float(f32(1) - f32(count + 1) ** f32(-FACTORED_DECAY_RATE))
        lr = self.schedule(count)
        wd_lr = float(f32(lr) * f32(self.weight_decay))
        step = _FactoredStep(self, norm, trigger, decay, lr, wd_lr)
        for (_, p), (_, g), (_, vr), (_, vc), (_, v), (_, mu) in pairs:
            dims = factored_dims(tuple(p.shape))
            if dims is None:
                for chunk in _update_chunks(p, g, v, mu):
                    step.unfactored(*chunk)
            else:
                step.factored(p, g, vr, vc, mu, *dims)
        state["count"] = count + 1
        return norm


def _rsqrt(x):
    """x ** -0.5 in x's dtype, computed in f32 and rounded once (torch's
    own bf16 power rounds otherwise than JAX's)."""
    return x.float().pow(-0.5).to(x.dtype)


class _FactoredStep:
    """One Adafactor update's constants and its per-leaf arithmetic (see
    Adafactor.update)."""

    def __init__(self, opt, norm, trigger, decay, lr, wd_lr):
        self.opt, self.norm, self.trigger = opt, norm, trigger
        self.decay, self.lr, self.wd_lr = decay, lr, wd_lr

    def _const(self, value, dtype):
        """A Python constant as JAX types it beside a `dtype` operand."""
        return _as_bf16(value) if dtype == torch.bfloat16 else value

    def _clipped(self, g):
        """clip_by_global_norm's select, without reading the norm back to
        the host."""
        scaled = g / self.norm.to(g.dtype) * self._const(self.opt.clip_norm,
                                                         g.dtype)
        return torch.where(self.trigger, g, scaled)

    def _square(self, g):
        return g * g + self._const(FACTORED_EPS, g.dtype)

    def _ema(self, new, mean):
        """decay * new(f32 or the leaf's dtype) + (1 - decay) * mean, f32
        (decay is an f32 array in optax, so both products are f32)."""
        return self.decay * new.float() + (1 - self.decay) * mean.float()

    def unfactored(self, p, g, v, mu):
        g = self._clipped(g)
        v_new = self._ema(v, self._square(g)).to(v.dtype)
        v.copy_(v_new)
        self._tail(p, g * _rsqrt(v_new), mu)

    def factored(self, p, g, v_row, v_col, mu, d1, d0):
        """A leaf factored over (d1, d0): each slice of its kept axes is a
        [R, C] matrix, R = shape[d1] rows and C = shape[d0] columns;
        v_row's slice is [R] (the mean over C), v_col's [C]."""
        kept = [i for i in range(p.ndim) if i not in (d1, d0)]
        perm = kept + [d1, d0]
        # v_row lacks d0 and v_col lacks d1; both keep the other axes in
        # their original order
        row_perm = [sorted(kept + [d1]).index(i) for i in kept + [d1]]
        col_perm = [sorted(kept + [d0]).index(i) for i in kept + [d0]]
        pv, gv, mv = (t.permute(perm) for t in (p, g, mu))
        rv, cv = v_row.permute(row_perm), v_col.permute(col_perm)
        R, C = p.shape[d1], p.shape[d0]
        rows = max(1, UPDATE_CHUNK // C)
        dtype = p.dtype
        for idx in np.ndindex(*[p.shape[i] for i in kept]):
            gs, ps, ms, rs, cs = (t[idx] for t in (gv, pv, mv, rv, cv))
            row_mean = torch.empty(R, dtype=torch.float32, device=p.device)
            col_sum = torch.zeros(C, dtype=torch.float32, device=p.device)
            for r in range(0, R, rows):
                sq = self._square(self._clipped(gs[r:r + rows])).float()
                row_mean[r:r + rows] = sq.sum(1) / C
                col_sum += sq.sum(0)
            # the means round to the leaf's dtype (jnp.mean sums in f32)
            row_new = self._ema(rs, row_mean.to(dtype)).to(dtype)
            col_new = self._ema(cs, (col_sum / R).to(dtype)).to(dtype)
            rs.copy_(row_new)
            cs.copy_(col_new)
            row_col_mean = (row_new.float().sum() / R).to(dtype)
            row_factor = _rsqrt(row_new / row_col_mean)
            col_factor = _rsqrt(col_new)
            for r in range(0, R, rows):
                g = self._clipped(gs[r:r + rows])
                u = g * row_factor[r:r + rows, None] * col_factor[None, :]
                self._tail(ps[r:r + rows], u, ms[r:r + rows])

    def _tail(self, p, u, mu):
        """scale_by_learning_rate, ema(b1) into mu, scale(-1), the
        decoupled weight decay and the parameter write, on one chunk."""
        opt = self.opt
        u = u * self._const(self.lr, u.dtype)
        new = (u * self._const(1 - opt.b1, u.dtype)
               + mu * self._const(opt.b1, mu.dtype))
        mu.copy_(new)
        p.copy_(p + (-new - self._const(self.wd_lr, p.dtype) * p))


# the opt-state keys each optimizer's init builds, to name the optimizer a
# mismatched state came from
_STATE_KEYS = {frozenset({"count", "mu", "nu"}): "AdamW",
               frozenset({"count", "v_row", "v_col", "v", "mu"}): "Adafactor"}


def check_opt_state(optimizer, state):
    """Guard: would `optimizer.init(state['params'])` build this opt state?

    A state built by one optimizer and stepped by another with other
    hyperparameters is silently wrong when the trees line up. The check
    builds the state `optimizer.init` would build on the meta device (no
    memory) and compares keys, shapes and dtypes with state['opt_state'];
    it raises a ValueError that names the mismatch, and the optimizer a
    state of other keys was built by (AdamW's against Adafactor's)."""
    meta = _map(lambda p: torch.empty_like(p, device="meta"),
                state["params"])
    expect = optimizer.init(meta)
    got = state["opt_state"]
    if set(expect) != set(got):
        raise ValueError(
            "optimizer/opt_state mismatch: %s.init(params) would build keys "
            "%s but state['opt_state'] has %s (%s's state); make_train_state "
            "and make_train_step must share ONE optimizer (use make_trainer), "
            "and a restored checkpoint must have been saved under the "
            "optimizer the trainer now uses"
            % (type(optimizer).__name__, sorted(expect), sorted(got),
               _STATE_KEYS.get(frozenset(got), "an unknown optimizer")))
    for name in sorted(k for k in expect if isinstance(expect[k], dict)):
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
                    "%s%s (same optimizer family, other mu_dtype or "
                    "factoring?)"
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


def _with_mesh(loss_fn, mesh):
    """loss_fn, given `mesh` as a keyword when there is one (the JAX
    trainer passes its mesh to a loss_fn that takes it)."""
    if mesh is None:
        return loss_fn
    return lambda params, batch, cfg, device: loss_fn(
        params, batch, cfg, device=device, mesh=mesh)


def _fence(device):
    """Wait for the work enqueued on `device` (CPU work is done when its
    call returns)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_train_step(cfg, model, optimizer=None, loss_fn=None, device="cuda",
                    mesh=None, timed_update=False):
    """The train step: (state, batch) -> (state, {'loss', 'grad_norm'}),
    both 0-dim f32 tensors on the device. The step updates the state's
    parameters and moments in place and returns the same dict. `mesh`
    (e.g. a LocalRing for attention_impl='ring') goes to loss_fn.

    timed_update: the JAX package's diagnostic split: the backward first,
    then the optimizer update, with a fence (the device's work waited
    for) at each side of the update, so `step.last_update_ms` holds the
    update's time on each call. training/metrics.py carries it into the
    step's telemetry record as `optimizer_update_ms`. The fences
    serialise work the host would otherwise run ahead of, so never time
    the step itself in this mode. The arithmetic is the unsplit step's.

    `optimizer` must be the one the state was built with; make_trainer
    shares one and checks it."""
    device = resolve_device(device)
    optimizer = optimizer or default_optimizer()
    loss_fn = _with_mesh(loss_fn or model.loss_fn, mesh)

    def step(state, batch):
        params = state["params"]
        for _, p in leaves(params):
            p.grad = None
        loss = loss_fn(params, batch, cfg, device=device)
        loss.backward()
        grads = _map(lambda p: p.grad, params)
        if timed_update:
            _fence(device)
            t0 = time.perf_counter()
        grad_norm = optimizer.update(params, grads, state["opt_state"])
        if timed_update:
            _fence(device)
            step.last_update_ms = (time.perf_counter() - t0) * 1e3
        for _, p in leaves(params):
            p.grad = None
        state["step"] += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    if timed_update:
        step.last_update_ms = None
    return step


def make_trainer(cfg, model, optimizer=None, loss_fn=None, params=None,
                 generator=None, device="cuda", mesh=None, checkpoint=None,
                 telemetry=None, timed_update=False):
    """One-stop builder: (state, train_step) sharing a SINGLE optimizer,
    with check_opt_state run on the built (or restored) state. Starts from
    `params` when given (see make_train_state); `mesh` goes to the step's
    loss_fn.

    timed_update: the diagnostic split step reporting per-call
    `optimizer_update_ms` through telemetry (see make_train_step).

    telemetry: truthy wraps the returned step with
    training.metrics.instrument_train_step so every call emits its
    `train.step` record (+ tokens/sec and MFU when the kwargs below are
    given) through the run's flight recorder. Pass True for defaults or a
    dict of instrument_train_step kwargs, e.g.
    ``telemetry={"tokens_per_step": batch * seq, "flops_per_step": ...}``;
    the wrapper's TrainStepTelemetry is `step.telemetry`.

    checkpoint: an AsyncCheckpointManager (training/checkpoint.py). When it
    holds a complete checkpoint, the built state's tensors are overwritten
    with it in place and its step and optimizer count are taken over, so a
    preempted run resumes instead of restarting; a checkpoint saved under
    another optimizer is refused with the optimizer named. The resumed step
    and the saved `extra` (e.g. the data stream's resume stamp) are then
    `checkpoint.last_restored`."""
    if knobs.get_bool("TPUFLOW_SANITIZE"):
        raise NotImplementedError(
            "TPUFLOW_SANITIZE is set, but the port has no collective "
            "sanitizer yet (ROADMAP.md, slice 5: the sanitizer)")
    optimizer = optimizer or default_optimizer()
    state = make_train_state(cfg, model, optimizer=optimizer, params=params,
                             generator=generator, device=device)
    step = make_train_step(cfg, model, optimizer=optimizer, loss_fn=loss_fn,
                           device=device, mesh=mesh,
                           timed_update=timed_update)
    if checkpoint is not None:
        restored = checkpoint.restore(like=state)
        if restored is not None:
            state = restored.state
    check_opt_state(optimizer, state)
    if telemetry:
        from .metrics import instrument_train_step

        kwargs = telemetry if isinstance(telemetry, dict) else {}
        step = instrument_train_step(step, **kwargs)
    return state, step


def make_eval_step(cfg, model, loss_fn=None, device="cuda", mesh=None):
    """(params, batch) -> loss, without gradients; `mesh` goes to
    loss_fn."""
    device = resolve_device(device)
    loss_fn = _with_mesh(loss_fn or model.loss_fn, mesh)

    @torch.no_grad()
    def step(params, batch):
        return loss_fn(params, batch, cfg, device=device)

    return step
