"""The yardstick's plain references: Beluga window by window
(``beluga``), ExPecto's variant scores and gene features (``expecto``) and
gblinear training (``gblinear``), in plain PyTorch and NumPy. Nothing here
imports the program."""
