"""End-to-end examples of the port, each run as
``python -m repro_torch.examples.<name> [--device cpu]`` (default
``cuda``): ``quickstart`` (the paper's §4.1 setup, grids, the fleet
grid, fans, races, the twin, chaos and training), ``fleet_twin`` (the
twin scheduling an accelerator fleet's model jobs through a pod
failure) and ``train_policy`` (train θ, score it, deploy it)."""
