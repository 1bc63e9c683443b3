"""Command-line entry points of the port, run as
``python -m understanding_flow_robustness_tpu_torch.cli.<name>``."""
