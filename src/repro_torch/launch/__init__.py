"""Launchers of the port (port of ``repro.launch``): ``train``, and the
dry run on a fake process group (``dryrun``, with ``mesh``, ``specs``,
``cost`` and ``roofline``)."""
