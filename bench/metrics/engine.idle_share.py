"""The card's idle time under the engine's host work, in percent of the
traced window: the idle gaps the profiler names after an ``engine.*``
span of ``core/engine.py`` (``engine.run``, the chunk loop's
``engine.chunk``, the kernel wrapper's ``engine.advance``).  A launch gap
inside an aten operation keeps the operation's name.  None without device
activity (no card), or from a program whose ``pass`` spans carry no
``state_bytes_to_host``: that program emits none of these spans."""
PREFIX = "engine."


def read(rec):
    if rec["busy_s"] <= 0 or rec["window_s"] <= 0 or not any(
            "state_bytes_to_host" in e.get("args", {}) for e in rec["spans"]):
        return None
    idle = sum(s for name, s in rec["gaps"].items() if name.startswith(PREFIX))
    return 100 * idle / rec["window_s"]
