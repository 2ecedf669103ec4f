"""Launchers of the port: ``python -m repro_torch.launch.{serve,train,dryrun}``, the meshes and the dry-run cells."""
