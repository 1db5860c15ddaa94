"""The plain reference: the published model's equations in float32 PyTorch
with TF32 off. It imports nothing of the program and takes its weights
from `pbench/weights.py`, made again from the seed."""
