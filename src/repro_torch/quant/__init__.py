"""The quantized host KV tier: int8 / packed int4 pool pages with float32
scales (reference ``repro/quant``)."""
