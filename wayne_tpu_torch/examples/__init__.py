"""Example scripts of the port, runnable as ``python -m
wayne_tpu_torch.examples.<name>``; importing them builds no kernel."""
