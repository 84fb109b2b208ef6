"""Optimizers and learning-rate schedules of the port's trainer.

Counterpart of `tpu_tts/train/optimizers.py` (`get_scheduler`:30,
`get_optimizer`:60, `apply_if_finite_select`:115). A schedule is a function
of the update count, equal to the optax schedule of the same name, and is
read before every update, as optax reads it. `get_optimizer` returns a
`TrainOptimizer`: a `torch.optim` optimizer behind the JAX chain's three
guards, in its order:

1. a non-finite gradient skips the whole update: parameters, moments and
   the update count stay as they were (`apply_if_finite`);
2. the gradients are clipped to a global norm (`clip_by_global_norm`: scaled
   by max / norm when the norm exceeds max);
3. the optimizer steps at the schedule's rate for this update.

With `accum_steps` k > 1 the gradients of k calls are averaged and applied
once, as `optax.MultiSteps`.

`radam` and `rmsprop` are written out here, because `torch.optim`'s differ
from optax's: `torch.optim.RAdam` adds eps to the uncorrected sqrt(v) and
rectifies when rho_t > 5, where `optax.scale_by_radam` divides by
sqrt(v̂) + eps and rectifies when rho_t ≥ 5; `torch.optim.RMSprop` adds eps
outside the square root, where `optax.scale_by_rms` takes rsqrt(ν + eps).
The JAX package's `rmsprop` reads `alpha` as the decay, 0.9 by default
(torch's default is 0.99), and chains `add_decayed_weights` before `radam`
when `weight_decay` is set.
"""

import math
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

Schedule = Callable[[int], float]


def noam_schedule(base_lr: float, warmup_steps: int = 4000) -> Schedule:
    """lr · warmup^0.5 · min(s · warmup^-1.5, s^-0.5) with s = step + 1."""

    def schedule(step: int) -> float:
        s = float(max(step + 1, 1))
        return base_lr * warmup_steps**0.5 * min(s * warmup_steps**-1.5, s**-0.5)

    return schedule


def exponential_decay(base_lr: float, transition_steps: int, decay_rate: float, staircase: bool = False) -> Schedule:
    """`optax.exponential_decay`: base · rate^(step / transition_steps)."""

    def schedule(step: int) -> float:
        p = step / transition_steps
        return base_lr * decay_rate ** (math.floor(p) if staircase else p)

    return schedule


def cosine_decay(base_lr: float, decay_steps: int) -> Schedule:
    """`optax.cosine_decay_schedule` with alpha 0."""

    def schedule(step: int) -> float:
        return base_lr * 0.5 * (1 + math.cos(math.pi * min(step, decay_steps) / decay_steps))

    return schedule


def stepwise_gradual(base_lr: float, rates) -> Schedule:
    """Piecewise-constant lr from `[[step, lr], ...]` (`optax.join_schedules`
    of constants: the rate of the last boundary ≤ step)."""
    rates = sorted((int(s), float(r)) for s, r in (rates or [[0, base_lr]]))
    init = rates[0][1] if rates[0][0] <= 0 else base_lr
    later = [(s, r) for s, r in rates if s > 0]

    def schedule(step: int) -> float:
        lr = init
        for s, r in later:
            if step >= s:
                lr = r
        return lr

    return schedule


def get_scheduler(name: Optional[str], params: Dict, base_lr: float) -> Union[float, Schedule]:
    if name is None:
        return base_lr
    name = name.lower().replace("lr", "")
    if name in ("noam", "noamlr"):
        return noam_schedule(base_lr, params.get("warmup_steps", 4000))
    if name in ("exponential", "exponentialdecay", "exponential_decay"):
        return exponential_decay(base_lr, params.get("decay_steps", 10000), params.get("gamma", 0.5))
    if name in ("steplr", "step"):
        return exponential_decay(base_lr, params.get("step_size", 10000), params.get("gamma", 0.5), staircase=True)
    if name in ("cosine", "cosinedecay"):
        return cosine_decay(base_lr, params.get("decay_steps", 100000))
    if name in ("stepwisegradual",):  # "StepwiseGradualLR" with the LR suffix stripped
        return stepwise_gradual(base_lr, params.get("gradual_learning_rates"))
    raise ValueError(f" [!] Unknown lr scheduler {name}")


def _pow32(base: float, n: int) -> np.float32:
    """base**n as XLA computes optax's bias corrections inside a compiled
    step: the base rounded to float32, the power taken exactly, the result
    rounded to float32."""
    return np.float32(float(np.float32(base)) ** n)


class OptaxRAdam(torch.optim.Optimizer):
    """`optax.radam` at the group's lr: Adam's moments, their bias
    corrections, and the rectified step r·m̂/(sqrt(v̂) + eps) once
    rho_t ≥ 5, the plain m̂ before; with `weight_decay` the gradient gets
    weight_decay·p first (`optax.add_decayed_weights`). The scalars (the
    corrections, rho_t and r) are computed in float32 as optax computes
    them, so the step count where rho_t crosses 5 and the steps agree."""

    def __init__(self, params, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=0.0, betas=tuple(betas), eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        f32 = np.float32
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            (b1, b2), eps, wd = group["betas"], group["eps"], group["weight_decay"]
            grads = [p.grad for p in params]
            if wd:
                grads = torch._foreach_add(grads, params, alpha=wd)
            states = [self.state[p] for p in params]
            for st, p in zip(states, params):
                if not st:
                    st.update(step=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p))
            mus, nus = [st["mu"] for st in states], [st["nu"] for st in states]
            torch._foreach_mul_(mus, b1)  # (1 - b1)·g + b1·m, optax's order
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
            t = states[0]["step"] + 1
            for st in states:
                st["step"] = t
            b2t = _pow32(b2, t)
            rho_inf = 2.0 / (1.0 - b2) - 1.0
            rho = f32(rho_inf) - f32(2 * t) * b2t / (f32(1.0) - b2t)
            updates = torch._foreach_div(mus, float(f32(1.0) - _pow32(b1, t)))
            if rho >= 5.0:
                r = np.sqrt((rho - f32(4.0)) * (rho - f32(2.0)) * f32(rho_inf)
                            / (f32((rho_inf - 4.0) * (rho_inf - 2.0)) * rho))
                denom = torch._foreach_sqrt(torch._foreach_div(nus, float(f32(1.0) - b2t)))
                torch._foreach_add_(denom, eps)
                torch._foreach_mul_(updates, float(r))
                torch._foreach_div_(updates, denom)
            torch._foreach_add_(params, torch._foreach_mul(updates, -group["lr"]))


class OptaxRMSprop(torch.optim.Optimizer):
    """`optax.rmsprop` at the group's lr: ν = decay·ν + (1 − decay)·g², the
    step g·rsqrt(ν + eps)."""

    def __init__(self, params, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, dict(lr=0.0, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            for p in params:
                if not self.state[p]:
                    self.state[p]["nu"] = torch.zeros_like(p)
            nus = [self.state[p]["nu"] for p in params]
            torch._foreach_mul_(nus, group["decay"])
            torch._foreach_addcmul_(nus, grads, grads, value=1 - group["decay"])
            scale = torch._foreach_rsqrt(torch._foreach_add(nus, group["eps"]))
            torch._foreach_mul_(scale, grads)
            torch._foreach_add_(params, scale, alpha=-group["lr"])


class TrainOptimizer:
    """A torch optimizer over `params` with the JAX chain's non-finite skip,
    global-norm clipping, optax's schedule and gradient accumulation."""

    def __init__(self, params: Sequence[torch.nn.Parameter], inner: torch.optim.Optimizer,
                 schedule: Union[float, Schedule], grad_clip: float = 0.0, accum_steps: int = 1):
        if accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {accum_steps}")
        self.params = list(params)
        self.inner = inner
        self.schedule = schedule
        self.grad_clip = float(grad_clip or 0.0)
        self.accum_steps = int(accum_steps)
        self.count = 0  # updates applied: the schedule's step
        self.notfinite_count = 0  # consecutive updates skipped for a non-finite gradient
        self.mini_step = 0

    def lr(self) -> float:
        return float(self.schedule(self.count)) if callable(self.schedule) else float(self.schedule)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> bool:
        """Apply the gradients the parameters hold (their mean over the last
        `accum_steps` calls) and clear them. Returns whether an update was
        applied; between accumulation boundaries the gradients are kept."""
        self.mini_step += 1
        if self.mini_step < self.accum_steps:
            return False
        self.mini_step = 0
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.accum_steps > 1:
            torch._foreach_mul_(grads, 1.0 / self.accum_steps)
        # the largest |g| of each tensor is finite only if all of it is (NaN propagates)
        finite = bool(torch.isfinite(torch.stack(torch._foreach_norm(grads, float("inf")))).all()) if grads else True
        if not finite:
            self.notfinite_count += 1
            self.zero_grad()
            return False
        self.notfinite_count = 0
        if self.grad_clip > 0 and grads:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.grad_clip, torch.ones_like(norm), self.grad_clip / norm)
            torch._foreach_mul_(grads, scale)
        for group in self.inner.param_groups:
            group["lr"] = self.lr()
        self.inner.step()
        self.count += 1
        self.zero_grad()
        return True

    def state_dict(self) -> Dict:
        return {"inner": self.inner.state_dict(), "count": self.count, "notfinite_count": self.notfinite_count,
                "mini_step": self.mini_step}

    def load_state_dict(self, state: Dict):
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])
        self.notfinite_count = int(state["notfinite_count"])
        self.mini_step = int(state["mini_step"])


def get_optimizer(name: str, params: Dict, model_params: Sequence[torch.nn.Parameter], config=None,
                  schedule: Union[float, Schedule, None] = None, optimizer_idx: Optional[int] = None,
                  lr: float = 0.001) -> TrainOptimizer:
    """A `TrainOptimizer` by the JAX package's optimizer names (adam, adamw,
    sgd, radam, rmsprop). `optimizer_idx` picks this optimizer's entry when `config.grad_clip`
    is a list (D = 0, G = 1)."""
    name = (name or "adam").lower()
    params = dict(params or {})
    betas = tuple(params.pop("betas", (0.9, 0.999)))
    weight_decay = params.pop("weight_decay", 0.0)
    eps = params.pop("eps", 1e-8)
    schedule = lr if schedule is None else schedule
    model_params = list(model_params)
    if name == "adam":
        inner = torch.optim.Adam(model_params, lr=0.0, betas=betas, eps=eps)
    elif name == "adamw":
        inner = torch.optim.AdamW(model_params, lr=0.0, betas=betas, eps=eps, weight_decay=weight_decay)
    elif name == "sgd":
        inner = torch.optim.SGD(model_params, lr=0.0, momentum=params.pop("momentum", 0.0))
    elif name == "radam":
        inner = OptaxRAdam(model_params, betas=betas, eps=eps, weight_decay=weight_decay)
    elif name == "rmsprop":
        inner = OptaxRMSprop(model_params, decay=params.pop("alpha", 0.9), eps=eps)
    else:
        raise ValueError(f" [!] Unknown optimizer {name}")
    grad_clip = getattr(config, "grad_clip", 0.0) if config is not None else 0.0
    if isinstance(grad_clip, (list, tuple)):
        if optimizer_idx is not None and optimizer_idx < len(grad_clip):
            grad_clip = grad_clip[optimizer_idx]
        else:
            grad_clip = max(grad_clip) if grad_clip else 0.0
    return TrainOptimizer(model_params, inner, schedule, grad_clip)
