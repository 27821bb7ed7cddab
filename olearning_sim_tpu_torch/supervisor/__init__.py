"""Crash-safe task supervision: reclaim expired-lease tasks, resume them.

The reference platform leans on Ray job supervision: a dead raylet's jobs
are re-scheduled by the cluster. The rebuild's engine jobs are in-process
threads, so process death used to equal task death —
``TaskManager._recover`` marked every orphaned RUNNING row FAILED even
though the checkpoint layer could restore round state bitwise. This package
closes that gap (docs/resilience.md "Leases, supervision & crash
recovery"): a :class:`TaskSupervisor` scans the task table for RUNNING
rows whose ownership lease expired, re-adopts them (lease claim, resource
re-freeze, deviceflow re-registration), and relaunches the engine job
through the existing checkpoint-resume path — with per-task resume
budgets and crash-loop backoff so a deterministically dying task degrades
to FAILED instead of livelocking. A copy of the JAX package's
``supervisor``.
"""

from olearning_sim_tpu_torch.supervisor.supervisor import TaskSupervisor

__all__ = ["TaskSupervisor"]
