"""The card's idle time under the service's own host work, in percent of
the traced window: the idle gaps the profiler names after
``service.schedule``, ``service.reduce``, ``service.flush``, or ``pass``
(a pass's time outside every span below it), all of ``service/api.py``.
``service.observe``, the telemetry's own cost in a traced run, is left
out.  None without device activity (no card), or from a program whose
``pass`` spans carry no ``state_bytes_to_host``: that program emits none
of these spans."""
NAMES = ("service.schedule", "service.reduce", "service.flush", "pass")


def read(rec):
    if rec["busy_s"] <= 0 or rec["window_s"] <= 0 or not any(
            "state_bytes_to_host" in e.get("args", {}) for e in rec["spans"]):
        return None
    idle = sum(rec["gaps"].get(name, 0.0) for name in NAMES)
    return 100 * idle / rec["window_s"]
