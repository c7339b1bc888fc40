"""Fault-tolerant training: preemption-aware checkpointing, auto-
resume, retry/rollback, hang watchdog, and a deterministic chaos
harness (the port's copy of ``paddle_tpu/resilience/``).

The reference's only recovery story is "checkpoint restart on the same
topology"; here the training loop itself owns the fault lifecycle. A
``Supervisor`` wraps ``Executor.run``: checkpoints commit atomically
(write-to-staging + marker + rename — ``io.latest_checkpoint`` can
never observe a partial write), a killed/preempted run auto-resumes
bit-exactly (the step counter, the run counter that seeds the random
ops and the reader position ride in the commit marker), transient
step failures retry with backoff, a non-finite loss rolls back to the
last commit and fires a user hook, and a watchdog catches hung steps. Every path is testable on demand
through flag-gated fault injection (``resilience_fault_spec``).

    from paddle_tpu_torch import resilience

    sup = resilience.Supervisor(
        exe, train_prog, checkpoint_dir="ckpts/run0",
        feed_fn=lambda step: make_feed(step), fetch_list=[loss])
    stats = sup.run_loop(num_steps=10_000)   # survives kill -9 restarts
"""

from .checkpoint import CheckpointPolicy
from .faults import (KILL_EXIT_CODE, FaultInjector, FaultSpec,
                     InjectedFault, check_save_kill)
from .supervisor import NonFiniteLossError, Supervisor, WatchdogTimeout

__all__ = [
    "Supervisor",
    "CheckpointPolicy",
    "FaultSpec",
    "FaultInjector",
    "InjectedFault",
    "WatchdogTimeout",
    "NonFiniteLossError",
    "KILL_EXIT_CODE",
    "check_save_kill",
]
