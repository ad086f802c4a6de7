"""Two-level weight-scaled virtual runtime accounting (paper section 5.1.1).

UFS tracks virtual runtime at two levels:

1. *task vruntime* -- runtime of a task within its group, scaled by the
   group's effective weight (weight-scaled virtual runtime);
2. *group vruntime* -- service received by the group as a whole, advanced by
   one slice scaled inversely by effective weight each time the group is
   charged at dispatch.

Clamping (section 5.1.2) limits how far behind the group's current vruntime a
task may lag, preventing long-idle tasks from hoarding credit and starving
recently-active peers on re-entry.
"""
from __future__ import annotations

from .task import Job, WorkloadGroup

# Weight normalisation: vruntime advances as wall/(eff_weight/SCALE), so a
# weight-100 (cgroup default) task's vruntime tracks wall time 1:1.
WEIGHT_SCALE = 100.0


def weight_scaled_delta(wall_delta: float, group: WorkloadGroup) -> float:
    """Convert wall-clock service into weight-scaled virtual runtime."""
    eff = max(group.effective_weight(), 1e-9)
    return wall_delta * (WEIGHT_SCALE / eff)


def charge_task(job: Job, wall_delta: float) -> float:
    """Charge ``wall_delta`` seconds of service to a task; returns the vdelta.
    A boosted job charges at its inherited (time-sensitive) group's weight --
    priority inheritance, so the boost is actually effective."""
    vdelta = weight_scaled_delta(wall_delta, job.sched_group())
    job.vruntime += vdelta
    job.total_cpu += wall_delta
    job.group.usage_time += wall_delta
    return vdelta


def charge_group(group: WorkloadGroup, slice_s: float) -> float:
    """Advance group vruntime by one slice scaled inversely by effective
    weight (paper: 'Its virtual runtime is then advanced by one time slice,
    scaled inversely by the cgroup's effective weight')."""
    vdelta = weight_scaled_delta(slice_s, group)
    group.vruntime += vdelta
    return vdelta


def clamp_task_vruntime(job: Job, slice_s: float) -> None:
    """Clamp a task's vruntime to at most one task slice behind its group's
    current task-level vruntime watermark (paper section 5.1.2, 'Clamping
    virtual runtime'): a long-idle task re-enters just behind the group's
    recently-active tasks instead of hoarding credit."""
    group = job.sched_group()
    floor = group.task_vmax - weight_scaled_delta(slice_s, group)
    if job.vruntime < floor:
        job.vruntime = floor


def clamp_group_vruntime(group: WorkloadGroup, min_tree_vruntime: float, slice_s: float) -> None:
    """When a group re-enters the runnable tree after being empty, clamp its
    vruntime near the current tree minimum so it cannot monopolise slots with
    stale credit (mirrors the task-level clamp one level up)."""
    floor = min_tree_vruntime - weight_scaled_delta(slice_s, group)
    if group.vruntime < floor:
        group.vruntime = floor
