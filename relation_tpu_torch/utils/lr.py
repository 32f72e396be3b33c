"""Learning-rate schedule: constant warmup, then multi-step decay (port of
relation_tpu/utils/lr.py; reference lib/utils/lr_scheduler.py:11-66).
lr = warmup_lr for the first warmup_step updates, then
base_lr * factor^k with k the number of step boundaries passed."""

from __future__ import annotations


def warmup_multi_factor_schedule(base_lr: float, steps, factor: float = 0.1,
                                 warmup: bool = False, warmup_lr: float = 0.0,
                                 warmup_step: int = 0):
    """Returns schedule(count: int) -> float; a boundary counts from the
    update whose count equals it."""
    steps = sorted(int(s) for s in steps)

    def schedule(count) -> float:
        count = int(count)
        if warmup and warmup_step > 0 and count < warmup_step:
            return float(warmup_lr)
        return float(base_lr) * float(factor) ** sum(count >= s for s in steps)

    return schedule
