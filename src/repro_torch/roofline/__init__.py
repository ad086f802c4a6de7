"""Roofline of a step on one NVIDIA H100: ``analysis`` (the hardware
model, the analytic model flops and memory, ``analyze`` of one call) and
``report`` (tables over a dry-run's results)."""
