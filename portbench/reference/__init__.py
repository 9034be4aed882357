"""The plain reference and the comparison that decides ``correct``:
plain PyTorch over the collection and queries the benchmark made, with
nothing of the port imported and nothing the port made read."""
