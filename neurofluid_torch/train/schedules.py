"""The e2e stage's learning-rate schedules as plain functions of the step
(port of the piecewise part of neurofluid_tpu/train/schedules.py).

Each `*_schedule` returns step -> learning rate, like the optax schedules
of the JAX package; `lr_lambda(schedule, init_value)` turns one into the
multiplicative factor that `torch.optim.lr_scheduler.LambdaLR` expects
(the optimizer's lr set to `init_value`). The piecewise factor is chosen
by `step > boundary`, with the e2e boundary tables of the reference.
"""

from __future__ import annotations

# e2e stage tables
E2E_RENDERER_BOUNDARIES = (10_000, 75_000, 150_000)
E2E_RENDERER_FACTORS = (1.0, 0.5, 0.25, 0.125)
E2E_TRANSITION_BOUNDARIES = (10_000, 30_000, 50_000, 100_000, 300_000)
E2E_TRANSITION_FACTORS = (1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125)


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
