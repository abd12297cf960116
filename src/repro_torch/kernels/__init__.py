"""Hand-written CUDA kernels (``csrc/``), their build (``build.py``), their
plain PyTorch versions (``ref.py``), the device dispatch (``ops.py``) and what
a launch costs (``cost.py``)."""
