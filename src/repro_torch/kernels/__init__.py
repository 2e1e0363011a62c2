"""Hand-written Hopper kernels (csrc/*.cu), their launch wrappers, their
plain PyTorch versions (ref.py) and the device dispatch between them
(ops.py)."""
