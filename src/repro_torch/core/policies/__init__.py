"""Baseline scheduling policies the paper evaluates UFS against.

* :class:`VDFPolicy`  -- EEVDF analogue: per-slot runqueues, virtual-deadline
  ordering, wakeup placement with the idle-sibling scan pathology, periodic +
  gated-newidle load balancing (paper section 3).
* :class:`IdlePolicy` -- SCHED_IDLE analogue for background jobs on top of VDF.
* :class:`RTPolicy`   -- SCHED_FIFO / SCHED_RR analogue with global RT queue,
  immediate cross-slot preemption and the "fair server" (RT throttling) that
  guarantees ~5% to the normal class (paper sections 3, 6.6).
"""
from .vdf import VDFPolicy
from .idle import IdlePolicy
from .rt import RTPolicy
from ..ufs import UFSPolicy

POLICIES = {
    "ufs": lambda: UFSPolicy(),
    "vdf": lambda: VDFPolicy(),
    "eevdf": lambda: VDFPolicy(),
    "idle": lambda: IdlePolicy(),
    "fifo": lambda: RTPolicy(quantum=None),
    "rr": lambda: RTPolicy(quantum=0.1),
}


def make_policy(name: str):
    try:
        return POLICIES[name]()
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; options: {sorted(POLICIES)}")
