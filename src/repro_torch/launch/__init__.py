"""Launchers of the port: `repro_torch.launch.serve` and
`repro_torch.launch.train`."""
