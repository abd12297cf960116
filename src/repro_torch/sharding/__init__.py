"""sharding of the PyTorch port (mirrors repro.sharding)."""
