"""Deterministic test harnesses shipped with the port (cf.
``glt_tpu/testing``): :class:`~glt_tpu_torch.testing.faults.FaultPlan`
injects preemptions, socket drops, delayed or corrupted frames,
producer deaths and disk faults at exact, reproducible points.
"""
from .faults import (FaultPlan, FaultyConnection, ProducerKilled,
                     SimulatedPreemption)

__all__ = ["FaultPlan", "FaultyConnection", "ProducerKilled",
           "SimulatedPreemption"]
