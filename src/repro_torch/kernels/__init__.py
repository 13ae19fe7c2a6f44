"""Hand-written Hopper kernels (``csrc/*.cu``), their build and their
wrappers (``ops``)."""
