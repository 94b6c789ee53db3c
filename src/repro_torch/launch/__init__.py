"""Launchers of the port: ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train`` and the meta-device dry run
``python -m repro_torch.launch.dryrun`` (with its ``specs`` and ``cost``);
``mesh``: meshes of ranks over ``torch.distributed`` and ``spawn``."""
