"""Frozen copies of what the yardstick needs, in plain PyTorch, importing
nothing of the port: the data laws, the accuracy arithmetic and the
card's published peaks."""
