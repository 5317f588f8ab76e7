"""The adaptive control plane (counterpart of ``hyperspace_tpu/adaptive/``):
three loops over sensors the lower tiers already feed.

- feedback.py: a process-wide correction store pairs the join reorderer's
  per-step estimates with the actual rows the executor records, feeds the
  learned corrections back into the reorderer, and re-plans a query once
  at a join boundary whose actual blew past its estimate.
- builder.py: a budgeted builder that runs in the serving tier's idle
  windows: it builds the advisor's top recommendation, retires indexes
  whose usage count stays zero, and compacts the streaming op logs.
- admission.py: SLO breach verdicts at the serving frontend: shed at
  submit, or degrade an eligible aggregate to a sampled answer with a
  stated error bound, and back to exact answers once health() clears.

All of it is off unless ``hyperspace.tpu.adaptive.enabled`` is true
(adaptive/constants.py, read through config.py).
"""

from .constants import AdaptiveConstants  # noqa: F401


def emit_action(session, action: str, subject: str = "", detail: str = "") -> None:
    """One AdaptiveActionEvent per control-plane decision (builder
    build/retire/maintain, admission engage/recover). An event that fails
    never fails the control plane."""
    try:
        from ..telemetry.events import AdaptiveActionEvent
        from ..telemetry.logging import log_event
        log_event(session, AdaptiveActionEvent(
            message=f"adaptive action: {action}" + (f" ({subject})" if subject else ""),
            action=action, subject=subject, detail=detail))
    except Exception:
        pass
