"""Launchers of the port: `repro_torch.launch.serve`."""
