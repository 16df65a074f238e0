"""Fault tolerance of the port's training loop: preemption, stragglers
(on a ``QuantileService`` stream), elastic rescale plans, step barriers."""
from .fault_tolerance import (ElasticPlan, PreemptionHandler, StepBarrier,
                              StragglerMonitor, plan_rescale)

__all__ = ["PreemptionHandler", "StragglerMonitor", "ElasticPlan",
           "plan_rescale", "StepBarrier"]
