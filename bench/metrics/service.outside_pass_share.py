"""The share of the traced window spent outside the service's passes, in
percent: one minus the summed ``pass`` spans of ``service/api.py`` (each
synchronized with the card) over the window.  It is the service's own
host time: scheduling, dedup, flushing responses, and the client's
submissions."""


def read(rec):
    if rec["window_s"] <= 0 or not rec["spans"]:
        return None
    inside = sum(e["dur"] for e in rec["spans"]) * 1e-6
    return 100 * (1 - inside / rec["window_s"])
