"""Hand-written CUDA kernels (``csrc/``), their build (``build.py``), their
plain PyTorch versions (``ref.py``) and the device dispatch (``ops.py``)."""
