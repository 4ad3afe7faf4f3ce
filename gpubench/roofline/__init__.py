"""The yardstick of the kernels' roofline shares: the card's published
peaks and, one file per kernel, the operations and bytes that each
launch's own inputs need (frozen copies of chip_smoke.py's counts)."""
