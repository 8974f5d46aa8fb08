"""Learning-rate schedules as plain functions of the step (port of
neurofluid_tpu/train/schedules.py).

Each returns step -> learning rate, like the optax schedules of the JAX
package: the warm-up stage's continuous exponential decay
lr * gamma^(step / decay_epochs), its variant with a linear warm-up, and the
e2e stage's piecewise factors, chosen by `step > boundary` with the e2e
boundary tables of the reference. `lr_lambda(schedule, init_value)` turns
one into the multiplicative factor that `torch.optim.lr_scheduler.LambdaLR`
expects (the optimizer's lr set to `init_value`). Stepped once after each
optimizer update, LambdaLR evaluates the schedule at the update count, as
optax does, and its state_dict carries that count across a checkpoint.
"""

from __future__ import annotations

# e2e stage tables
E2E_RENDERER_BOUNDARIES = (10_000, 75_000, 150_000)
E2E_RENDERER_FACTORS = (1.0, 0.5, 0.25, 0.125)
E2E_TRANSITION_BOUNDARIES = (10_000, 30_000, 50_000, 100_000, 300_000)
E2E_TRANSITION_FACTORS = (1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125)


def exponential_decay(init_value: float, decay_epochs: int,
                      gamma: float = 0.1):
    def schedule(step):
        return init_value * gamma ** (step / decay_epochs)

    return schedule


def warmup_exponential_decay(init_value: float, decay_epochs: int,
                             warmup_epochs: int = 10_000, gamma: float = 0.1):
    def schedule(step):
        if step < warmup_epochs:
            return init_value * (step + 1.0) / warmup_epochs
        return init_value * gamma ** (step / decay_epochs)

    return schedule


def piecewise_factors(init_value: float, boundaries, factors):
    """factor = factors[number of boundaries strictly below step]."""
    if len(factors) != len(boundaries) + 1:
        raise ValueError("need one more factor than boundaries")

    def schedule(step):
        return init_value * factors[sum(step > b for b in boundaries)]

    return schedule


def e2e_renderer_schedule(init_value: float = 3e-4):
    return piecewise_factors(init_value, E2E_RENDERER_BOUNDARIES,
                             E2E_RENDERER_FACTORS)


def e2e_transition_schedule(init_value: float = 1e-5):
    return piecewise_factors(init_value, E2E_TRANSITION_BOUNDARIES,
                             E2E_TRANSITION_FACTORS)


def lr_lambda(schedule, init_value: float):
    """`schedule` as LambdaLR's factor of the optimizer's lr `init_value`."""
    return lambda step: schedule(step) / init_value
