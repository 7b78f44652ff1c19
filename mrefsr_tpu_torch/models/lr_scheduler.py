"""Learning-rate schedules as pure functions step -> multiplier, and the
scheduler that applies one to an optimizer (port of
``mrefsr_tpu/models/lr_scheduler.py``).

``step`` counts completed optimizer updates: 0 on the first step, i.e.
``current_iter - 1`` in the reference's 1-based iterations.
"""
import math
from bisect import bisect_left, bisect_right


def multistep_lr(milestones, gamma=0.1):
    """``gamma ** #{milestones <= step}``: torch's MultiStepLR, stepped
    every iteration."""
    ms = sorted(int(m) for m in milestones)
    return lambda step: gamma ** bisect_right(ms, step)


def multistep_restart_lr(milestones, gamma=0.1, restarts=(0,),
                         restart_weights=(1,)):
    """MultiStepRestartLR (reference lr_scheduler.py:6-34): gamma decay at
    the milestones; at each restart iteration the multiplier resets to the
    restart's weight and the decay counts from there."""
    if len(restarts) != len(restart_weights):
        raise ValueError('restarts and their weights do not match.')
    ms = sorted(int(m) for m in milestones)
    restarts = [int(r) for r in restarts]

    def schedule(step):
        fired = [i for i, r in enumerate(restarts) if r <= step]
        last = max((restarts[i] for i in fired), default=0)
        weight = restart_weights[max(i for i in fired
                                     if restarts[i] == last)] if fired else 1
        return weight * gamma ** (bisect_right(ms, step)
                                  - bisect_right(ms, last))

    return schedule


def cosine_annealing_restart_lr(periods, restart_weights=(1,), eta_min=0,
                                base_lr=1.0):
    """CosineAnnealingRestartLR (reference lr_scheduler.py:57-97), as a
    multiplier of ``base_lr``; ``eta_min`` is an absolute floor."""
    if len(periods) != len(restart_weights):
        raise ValueError('periods and restart_weights should have the same '
                         'length.')
    cumulative = []
    for period in periods:
        cumulative.append(period + (cumulative[-1] if cumulative else 0))
    ratio = eta_min / base_lr

    def schedule(step):
        idx = min(bisect_left(cumulative, step), len(periods) - 1)
        start = cumulative[idx - 1] if idx else 0
        return ratio + restart_weights[idx] * 0.5 * (1 - ratio) * (
            1 + math.cos(math.pi * (step - start) / periods[idx]))

    return schedule


def with_warmup(schedule, warmup_iter=-1):
    """Linear warm-up (reference base_model.py:172-193): while
    ``current_iter < warmup_iter`` the multiplier is
    ``current_iter / warmup_iter``, so the first step gets 1 / warmup and
    not 0."""
    if warmup_iter is None or warmup_iter <= 0:
        return schedule

    def warmed(step):
        it = step + 1
        return it / warmup_iter if it < warmup_iter else schedule(step)

    return warmed


def build_schedule(scheduler_opt, warmup_iter=-1, base_lr=1.0):
    """The schedule of a YAML ``scheduler:`` block (type MultiStepLR,
    MultiStepRestartLR or CosineAnnealingRestartLR). ``base_lr`` is the
    primary group's learning rate, for the cosine schedule's absolute
    ``eta_min``."""
    opt = dict(scheduler_opt or {})
    stype = opt.pop('type', 'MultiStepLR')
    if stype == 'MultiStepLR':
        sched = multistep_lr(opt.get('milestones', []),
                             opt.get('gamma', 0.1))
    elif stype == 'MultiStepRestartLR':
        sched = multistep_restart_lr(opt.get('milestones', []),
                                     opt.get('gamma', 0.1),
                                     opt.get('restarts', (0,)),
                                     opt.get('restart_weights', (1,)))
    elif stype == 'CosineAnnealingRestartLR':
        sched = cosine_annealing_restart_lr(
            opt['periods'], opt.get('restart_weights', (1,)),
            opt.get('eta_min', 0), base_lr=base_lr or 1.0)
    else:
        raise NotImplementedError(
            f'Scheduler {stype} is not implemented yet.')
    return with_warmup(sched, warmup_iter)


class ScheduleLR:
    """Sets every parameter group of ``optimizer`` to
    ``base_lr * schedule(current_iter - 1)``: the rate that iteration
    ``current_iter`` trains with. The base rates are the groups' rates
    when this object is made."""

    def __init__(self, optimizer, schedule):
        self.optimizer = optimizer
        self.schedule = schedule
        self.base_lrs = [group['lr'] for group in optimizer.param_groups]
        self.last_iter = 0

    def step(self, current_iter):
        self.last_iter = current_iter
        mult = self.schedule(current_iter - 1)
        for group, lr in zip(self.optimizer.param_groups, self.base_lrs):
            group['lr'] = lr * mult

    def get_last_lr(self):
        return [group['lr'] for group in self.optimizer.param_groups]

    def state_dict(self):
        return {'base_lrs': list(self.base_lrs), 'last_iter': self.last_iter}

    def load_state_dict(self, state):
        self.base_lrs = list(state['base_lrs'])
        self.last_iter = state['last_iter']
