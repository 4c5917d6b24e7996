"""Optimizers and LR schedules; mirror of tfimm_tpu/train/optimizers.py.

The JAX package builds optax transformations. Here each optimizer is the
``torch.optim`` optimizer with the same update rule, and each schedule a
plain function of the step that mirrors its optax counterpart. ``Optimizer``
applies the chain in optax's order: clip the gradients, set the learning
rate to ``schedule(step)`` (step 0 first, as optax counts), update.

Ported: ``sgd`` (momentum ``betas[0]``, as ``optax.sgd``), ``adam``,
``adamw`` (decoupled decay of every parameter, as ``optax.adamw`` without a
mask), ``clipnorm`` (optax's global-norm form, with no epsilon) and
``clipvalue``. ``rmsprop``, ``adamax``, ``adadelta``, ``adagrad`` and
``accum_steps > 1`` raise: their optax and ``torch.optim`` update rules
differ (ROADMAP.md, queue A, item 16). bf16 mixed precision needs no loss
scaling (bf16 has float32's exponent range).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Tuple

import torch

from tfimm_tpu_torch.train.registry import cfg_serializable, get_class

__all__ = ["OptimizerConfig", "OptimizerFactory", "Optimizer", "LRConstFactory",
           "LRMultiStepsFactory", "LRCosineDecayFactory", "LRExpDecayFactory",
           "constant_schedule", "piecewise_constant_schedule",
           "cosine_decay_schedule", "exponential_decay", "linear_schedule",
           "join_schedules"]

Schedule = Callable[[int], float]

_NOT_PORTED = ("rmsprop", "adamax", "adadelta", "adagrad")


@dataclass
class OptimizerConfig:
    lr_schedule: Any = None
    lr_schedule_class: str = ""
    lr_warmup: int = -1  # epochs of linear warmup; -1 disables
    optimizer: str = "sgd"
    betas: tuple = (0.9, 0.999)
    weight_decay: float = 0.0  # decoupled decay (adamw); 0 disables
    clipnorm: float = -1.0
    clipvalue: float = -1.0
    # Average gradients over N micro-steps before applying one update.
    accum_steps: int = 1
    epsilon: float = 1e-7
    rho: float = 0.95
    initial_accumulator_value: float = 0.1


# -- schedules: plain functions of the step, as optax computes them ------------

def constant_schedule(value: float) -> Schedule:
    return lambda step: value


def piecewise_constant_schedule(init_value: float,
                                boundaries_and_scales: Dict[int, float]) -> Schedule:
    """``init_value`` times every scale whose boundary the step has reached."""
    def schedule(step):
        value = init_value
        for boundary, scale in sorted(boundaries_and_scales.items()):
            if step >= boundary:
                value *= scale
        return value
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, "
                         f"got {decay_steps}")

    def schedule(step):
        count = min(step, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)
    return schedule


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float, staircase: bool = False) -> Schedule:
    if transition_steps <= 0 or decay_rate == 0:
        return constant_schedule(init_value)

    def schedule(step):
        if step <= 0:
            return init_value
        p = step / transition_steps
        return init_value * decay_rate ** (math.floor(p) if staircase else p)
    return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(step):
        frac = 1.0 - min(max(step, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def join_schedules(schedules, boundaries) -> Schedule:
    """Schedule i + 1 takes over at boundary i, counting from it."""
    def schedule(step):
        value = schedules[0](step)
        for boundary, later in zip(boundaries, schedules[1:]):
            if step >= boundary:
                value = later(step - boundary)
        return value
    return schedule


# -- the optimizer ---------------------------------------------------------------

class Optimizer:
    """A ``torch.optim`` optimizer driven as an optax chain. ``step()``
    clips the gradients (``clipnorm``: ``g * c / ‖g‖`` when the global norm
    ``‖g‖`` reaches ``c``; ``clipvalue``: each entry into ``[-c, c]``), sets
    every group's learning rate to ``schedule(step_count)`` and updates."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Schedule, *,
                 clipnorm: float = -1.0, clipvalue: float = -1.0):
        self.optimizer = optimizer
        self.schedule = schedule
        self.clipnorm = clipnorm
        self.clipvalue = clipvalue
        self.step_count = 0

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for group in self.optimizer.param_groups
                 for p in group["params"] if p.grad is not None]
        if self.clipnorm != -1.0 and grads:
            norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            for g in grads:
                g.copy_(torch.where(norm < self.clipnorm, g,
                                    g / norm * self.clipnorm))
        elif self.clipvalue != -1.0:
            for g in grads:
                g.clamp_(-self.clipvalue, self.clipvalue)
        lr = self.schedule(self.step_count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step_count += 1

    def state_dict(self) -> Dict[str, Any]:
        return {"optimizer": self.optimizer.state_dict(),
                "step_count": self.step_count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        # torch.optim keeps a step count on the CPU unless the group is
        # capturable or fused; a checkpoint read onto the card brings it
        # there, where every update would read it back with a sync.
        for group in self.optimizer.param_groups:
            if group.get("capturable") or group.get("fused"):
                continue
            for p in group["params"]:
                st = self.optimizer.state.get(p, {})
                if isinstance(st.get("step"), torch.Tensor):
                    st["step"] = st["step"].cpu()
        self.step_count = int(state["step_count"])


@cfg_serializable
class OptimizerFactory:
    cfg_class = OptimizerConfig

    def __init__(self, cfg: OptimizerConfig, timekeeping,
                 mixed_precision: bool = False):
        self.cfg = cfg
        self.timekeeping = timekeeping
        self.mixed_precision = mixed_precision  # informational (bf16)

    def lr_schedule(self) -> Schedule:
        """step -> learning rate, with the optional linear warmup."""
        schedule = get_class(self.cfg.lr_schedule_class)(
            cfg=self.cfg.lr_schedule, timekeeping=self.timekeeping
        )()
        if self.cfg.lr_warmup != -1:
            warmup_steps = (self.cfg.lr_warmup
                            * self.timekeeping.nb_steps_per_epoch)
            base = schedule
            warmup = linear_schedule(0.0, base(0), warmup_steps)
            schedule = join_schedules(
                [warmup, lambda step: base(step + warmup_steps)],
                boundaries=[warmup_steps],
            )
        return schedule

    def optimizer(self, params: Iterable[torch.nn.Parameter],
                  schedule: Schedule) -> Optimizer:
        cfg = self.cfg
        if cfg.clipnorm != -1.0 and cfg.clipvalue != -1.0:
            raise ValueError("clipnorm and clipvalue cannot both be used.")
        if cfg.optimizer in _NOT_PORTED or cfg.accum_steps > 1:
            raise NotImplementedError(
                f"optimizer={cfg.optimizer!r}, accum_steps={cfg.accum_steps}: "
                f"rmsprop, adamax, adadelta, adagrad and gradient "
                f"accumulation are not ported yet (ROADMAP.md, queue A, "
                f"item 16)")
        params = list(params)
        lr = schedule(0)
        if cfg.optimizer == "sgd":
            opt = torch.optim.SGD(params, lr=lr, momentum=cfg.betas[0] or 0.0)
        elif cfg.optimizer == "adam":
            opt = torch.optim.Adam(params, lr=lr, betas=tuple(cfg.betas),
                                   eps=cfg.epsilon)
        elif cfg.optimizer == "adamw":
            opt = torch.optim.AdamW(params, lr=lr, betas=tuple(cfg.betas),
                                    eps=cfg.epsilon,
                                    weight_decay=cfg.weight_decay)
        else:
            raise ValueError(f"Unknown optimizer: {cfg.optimizer}")
        return Optimizer(opt, schedule, clipnorm=cfg.clipnorm,
                         clipvalue=cfg.clipvalue)

    def __call__(self, params) -> Tuple[Optimizer, Schedule]:
        schedule = self.lr_schedule()
        return self.optimizer(params, schedule), schedule


# -- schedule factories (epoch-denominated via Timekeeping) ------------------------

@dataclass
class LRConstConfig:
    lr: float = 0.01


@cfg_serializable
class LRConstFactory:
    cfg_class = LRConstConfig

    def __init__(self, cfg, timekeeping):
        self.cfg = cfg
        self.timekeeping = timekeeping

    def __call__(self) -> Schedule:
        return constant_schedule(self.cfg.lr)


@dataclass
class LRMultiStepsConfig:
    lr_boundaries: tuple = ()  # in epochs
    lr_values: tuple = ()


@cfg_serializable
class LRMultiStepsFactory:
    cfg_class = LRMultiStepsConfig

    def __init__(self, cfg, timekeeping):
        self.cfg = cfg
        self.timekeeping = timekeeping

    def __call__(self) -> Schedule:
        steps_per_epoch = self.timekeeping.nb_steps_per_epoch
        boundaries_and_scales = {}
        values = list(self.cfg.lr_values)
        for epoch, (prev, new) in zip(self.cfg.lr_boundaries,
                                      zip(values[:-1], values[1:])):
            boundaries_and_scales[epoch * steps_per_epoch] = new / prev
        return piecewise_constant_schedule(values[0], boundaries_and_scales)


@dataclass
class LRCosineDecayConfig:
    lr: float = 0.01
    alpha: float = 0.0


@cfg_serializable
class LRCosineDecayFactory:
    cfg_class = LRCosineDecayConfig

    def __init__(self, cfg, timekeeping):
        self.cfg = cfg
        self.timekeeping = timekeeping

    def __call__(self) -> Schedule:
        return cosine_decay_schedule(
            self.cfg.lr, decay_steps=self.timekeeping.nb_steps,
            alpha=self.cfg.alpha)


@dataclass
class LRExpDecayConfig:
    lr: float = 0.01
    lr_decay_rate: float = 0.97
    lr_decay_frequency: int = 1  # in epochs
    staircase: bool = True


@cfg_serializable
class LRExpDecayFactory:
    cfg_class = LRExpDecayConfig

    def __init__(self, cfg, timekeeping):
        self.cfg = cfg
        self.timekeeping = timekeeping

    def __call__(self) -> Schedule:
        return exponential_decay(
            self.cfg.lr,
            transition_steps=(self.cfg.lr_decay_frequency
                              * self.timekeeping.nb_steps_per_epoch),
            decay_rate=self.cfg.lr_decay_rate,
            staircase=self.cfg.staircase,
        )
