"""Launchers of the port (port of ``repro.launch``): ``train``.  The dry
run, the roofline and the HLO cost model go with A14."""
