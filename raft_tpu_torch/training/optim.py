"""Schedules and the optimizer, with optax's semantics.

The JAX package's ``training/optim.py`` builds ``apply_if_finite(chain(
clip_by_global_norm(clip_norm), {adamw | adam | sgd*}), 8)`` on optax.
This module computes that chain itself, on the parameters' device, in
float32, with no host sync, in optax's order of operations:

* ``clip_by_global_norm``: each gradient is kept as it is when the global
  norm is below ``clip_norm``, else replaced by ``(g / norm) * clip_norm``
  (not PyTorch's ``clip_grad_norm_``, which divides by ``norm + 1e-6``
  and scales whenever the norm exceeds the bound);
* ``adamw`` (``scale_by_adam`` with ``eps_root=0``, then the decoupled
  decay ``+ weight_decay * param`` on every leaf, no mask, then the
  schedule's ``-lr``), ``adam`` (no decay), or ``sgd`` with momentum 0.9
  (``trace``: ``t = g + 0.9 t``), each step's learning rate read from the
  schedule at the inner count starting from 0;
* ``apply_if_finite(max_consecutive_errors=8)``: a step whose gradients
  hold a NaN or an infinity applies a zero update and leaves the inner
  state (moments, counts) unchanged, unless it is the 9th such step in a
  row; it counts ``notfinite_count``, ``last_finite`` and
  ``total_notfinite``.

The schedules are the JAX package's: ``one_cycle_schedule`` is two linear
pieces (optax's ``join_schedules`` of two ``linear_schedule``), not
``torch.optim.lr_scheduler.OneCycleLR`` (a cosine anneal by default, with
cycled momentum).  The optimizer state's leaves are named as optax's tree
(:meth:`OptState.leaves`), so a checkpoint's ``opt_state/...`` leaves map
one to one between the packages (``convert/weights.py``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..config import TrainConfig

INT32_MAX = 2 ** 31 - 1
MAX_CONSECUTIVE_ERRORS = 8
B1, B2, MOMENTUM = 0.9, 0.999, 0.9

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax's ``linear_schedule(init, end, steps)`` on an int32 count."""
    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = torch.clamp(count, 0, steps)
        frac = 1 - c / steps
        return (init - end) * frac + end
    return schedule


def one_cycle_schedule(max_lr: float, total_steps: int,
                       pct_start: float = 0.05, div_factor: float = 25.0,
                       final_div: float = 1e4) -> Schedule:
    """Linear one-cycle: from ``max_lr / div_factor`` up to ``max_lr`` over
    the first ``pct_start`` of the steps, then linearly down to
    ``max_lr / div_factor / final_div``."""
    warm = max(int(total_steps * pct_start), 1)
    init_lr = max_lr / div_factor
    final_lr = init_lr / final_div
    up = _linear(init_lr, max_lr, warm)
    down = _linear(max_lr, final_lr, max(total_steps - warm, 1))

    def schedule(count: torch.Tensor) -> torch.Tensor:
        return torch.where(count < warm, up(count), down(count - warm))
    return schedule


def cyclic_schedule(max_lr: float, period: int = 2000,
                    base_frac: float = 0.1) -> Schedule:
    """Triangular cyclic learning rate ('sgd_cyclic')."""
    base_lr = max_lr * base_frac

    def schedule(count: torch.Tensor) -> torch.Tensor:
        cycle_pos = (count % period) / period
        tri = 1.0 - torch.abs(2.0 * cycle_pos - 1.0)
        return base_lr + (max_lr - base_lr) * tri
    return schedule


def constant_schedule(value: float) -> Schedule:
    def schedule(count: torch.Tensor) -> torch.Tensor:
        return torch.full((), value, dtype=torch.float32, device=count.device)
    return schedule


def make_schedule(tc: TrainConfig) -> Schedule:
    if tc.schedule == "one_cycle":
        return one_cycle_schedule(tc.lr, tc.num_steps, tc.pct_start)
    if tc.schedule == "cyclic":
        return cyclic_schedule(tc.lr)
    if tc.schedule == "constant":
        return constant_schedule(tc.lr)
    raise ValueError(tc.schedule)


def _inc(count: torch.Tensor) -> torch.Tensor:
    """optax's ``safe_increment`` of an int32 count."""
    return torch.where(count < INT32_MAX, count + 1, count)


def _zeros_i32(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares."""
    total = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
    for t in tensors:
        total = total + torch.square(t).sum()
    return torch.sqrt(total)


def all_finite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """A 0-dim bool tensor: every element of every tensor is finite."""
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


class OptState:
    """The optimizer's state, leaf for leaf optax's: the adam family's
    ``count``, ``mu`` and ``nu`` (one tensor per parameter) or sgd's
    ``trace``; the schedule's ``sched_count``; under
    ``skip_nonfinite_updates`` the wrapper's ``notfinite_count``,
    ``last_finite`` and ``total_notfinite``.  Every leaf is a tensor on
    the parameters' device."""

    def __init__(self, kind: str, index: Tuple[int, int], wrapped: bool,
                 params: Sequence[torch.Tensor]):
        dev = params[0].device
        self.kind = kind                   # "adam" or "sgd"
        self._index = index                # (moments, schedule) in the chain
        self.wrapped = wrapped
        if kind == "adam":
            self.count = _zeros_i32(dev)
            self.mu = [torch.zeros_like(p) for p in params]
            self.nu = [torch.zeros_like(p) for p in params]
        else:
            self.trace = [torch.zeros_like(p) for p in params]
        self.sched_count = _zeros_i32(dev)
        if wrapped:
            self.notfinite_count = _zeros_i32(dev)
            self.last_finite = torch.ones((), dtype=torch.bool, device=dev)
            self.total_notfinite = _zeros_i32(dev)

    def leaves(self) -> List[Tuple[str, object]]:
        """``(optax path, tensor or per-parameter list)`` pairs, the path
        relative to ``opt_state/``: the wrapper's counters, then the inner
        chain (``1/`` is the chain after ``clip_by_global_norm``, whose
        state is empty) under ``inner_state/``."""
        inner = "inner_state/" if self.wrapped else ""
        m, s = self._index
        out = []
        if self.wrapped:
            out += [("notfinite_count", self.notfinite_count),
                    ("last_finite", self.last_finite),
                    ("total_notfinite", self.total_notfinite)]
        if self.kind == "adam":
            out += [(f"{inner}1/{m}/count", self.count),
                    (f"{inner}1/{m}/mu", self.mu),
                    (f"{inner}1/{m}/nu", self.nu)]
        else:
            out += [(f"{inner}1/{m}/trace", self.trace)]
        out.append((f"{inner}1/{s}/count", self.sched_count))
        return out


class Optimizer:
    """``clip_by_global_norm -> {adamw | adam | sgd*} -> apply_if_finite``
    of a :class:`TrainConfig` (the JAX package's ``make_optimizer``):
    :meth:`init` builds the state, :meth:`update` applies one step in
    place."""

    def __init__(self, tc: TrainConfig, schedule: Optional[Schedule] = None):
        name = tc.optimizer
        sched = schedule if schedule is not None else make_schedule(tc)
        if name == "sgd_cyclic":
            sched = cyclic_schedule(tc.lr)
        elif name == "sgd_1cycle":
            sched = one_cycle_schedule(tc.lr, tc.num_steps, tc.pct_start)
        if name in ("adamw", "adam"):
            self.kind = "adam"
            # adamw's chain is (adam, decayed weights, schedule)
            self.index = (0, 2) if name == "adamw" else (0, 1)
        elif name in ("sgd", "sgd_cyclic", "sgd_1cycle"):
            self.kind = "sgd"
            self.index = (0, 1)
        else:
            raise ValueError(name)
        self.weight_decay = tc.weight_decay if name == "adamw" else None
        self.eps = tc.adamw_eps
        self.clip_norm = tc.clip_norm
        self.wrapped = tc.skip_nonfinite_updates
        self.schedule = sched

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        return OptState(self.kind, self.index, self.wrapped, params)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: OptState,
               params: Sequence[torch.Tensor]) -> torch.Tensor:
        """Apply one step to ``params`` and ``state`` in place; returns the
        gradients' global norm before clipping (a 0-dim tensor)."""
        accept = None
        if self.wrapped:
            finite = all_finite(grads)
            nfc = torch.where(finite, torch.zeros_like(state.notfinite_count),
                              _inc(state.notfinite_count))
            accept = finite | (nfc > MAX_CONSECUTIVE_ERRORS)
            state.total_notfinite.copy_(torch.where(
                finite, state.total_notfinite, _inc(state.total_notfinite)))
            state.notfinite_count.copy_(nfc)
            state.last_finite.copy_(finite)

        def commit(dst: torch.Tensor, new: torch.Tensor) -> None:
            dst.copy_(new if accept is None else torch.where(accept, new, dst))

        g_norm = global_norm(grads)
        trigger = g_norm < self.clip_norm
        grads = [torch.where(trigger, g, (g / g_norm) * self.clip_norm)
                 for g in grads]
        step_size = -self.schedule(state.sched_count)
        if self.kind == "adam":
            count = _inc(state.count)
            bc1 = 1 - torch.pow(torch.full((), B1, device=count.device),
                                count.float())
            bc2 = 1 - torch.pow(torch.full((), B2, device=count.device),
                                count.float())
            for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
                mu_new = (1 - B1) * g + B1 * mu
                nu_new = (1 - B2) * torch.square(g) + B2 * nu
                u = (mu_new / bc1) / (torch.sqrt(nu_new / bc2 + 0.0) + self.eps)
                if self.weight_decay is not None:
                    u = u + self.weight_decay * p
                commit(mu, mu_new)
                commit(nu, nu_new)
                commit(p, p + step_size * u)
            commit(state.count, count)
        else:
            for p, g, tr in zip(params, grads, state.trace):
                tr_new = g + MOMENTUM * tr
                commit(tr, tr_new)
                commit(p, p + step_size * tr_new)
        commit(state.sched_count, _inc(state.sched_count))
        return g_norm


def make_optimizer(tc: TrainConfig, schedule: Optional[Schedule] = None
                   ) -> Optimizer:
    return Optimizer(tc, schedule)
