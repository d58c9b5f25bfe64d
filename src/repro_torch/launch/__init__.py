"""Launchers of the port: ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``, and the dry-run tools
``launch.dryrun`` / ``launch.roofline`` / ``launch.hillclimb`` (every step on
the ``meta`` device, priced on the H100 data sheet)."""
