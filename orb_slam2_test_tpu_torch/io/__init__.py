"""I/O: settings files, dataset loaders, live frame sources, trajectory
export and checkpoints (copies of the JAX package's host modules, with
the port's types; PyYAML and OpenCV are imported only by the functions
that read YAML files or images)."""
