"""Bytes the burned-state cache moves between the card and the host per
row measured: the ``state_bytes_to_host`` and ``state_bytes_to_device``
of the service's ``pass`` spans (burned rows down, assembled states up,
counted in ``_burned_state`` where each copy happens), summed, over their
``n_rows``.  A counter of the program, so the mix alone sets it; 0 where
nothing is burned in.  None without a card (nothing crosses to a host
that is the device) or from a program without the counters."""


def read(rec):
    spans = [e["args"] for e in rec["spans"]
             if "state_bytes_to_host" in e.get("args", {})]
    rows = sum(a["n_rows"] for a in spans)
    if rows <= 0 or not rec.get("card"):
        return None
    return sum(a["state_bytes_to_host"] + a["state_bytes_to_device"]
               for a in spans) / rows
