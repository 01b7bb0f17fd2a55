"""Scripts for work on the kernels (run on a machine with a card)."""
