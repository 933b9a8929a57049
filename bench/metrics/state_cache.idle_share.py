"""The card's idle time under the state cache's host work, in percent of
the traced window: the idle gaps the profiler names after a
``state_cache.*`` span of ``service/api.py``'s ``_burned_state`` (the
lookup, the copy to the host, ``put_batch``, the assembly, the copy to
the device).  None without device activity (no card), or from a program
whose ``pass`` spans carry no ``state_bytes_to_host``: that program emits
none of these spans."""
PREFIX = "state_cache."


def read(rec):
    if rec["busy_s"] <= 0 or rec["window_s"] <= 0 or not any(
            "state_bytes_to_host" in e.get("args", {}) for e in rec["spans"]):
        return None
    idle = sum(s for name, s in rec["gaps"].items() if name.startswith(PREFIX))
    return 100 * idle / rec["window_s"]
