"""Launchers: ``python -m repro_torch.launch.train`` (:mod:`.train`)."""
