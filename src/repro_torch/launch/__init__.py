"""Entry points of the port: ``python -m repro_torch.launch.serve``,
``.train``, ``.dryrun`` (the production meshes over fake tensors) and
``.perf`` (roofline variants of three dry-run cells)."""
