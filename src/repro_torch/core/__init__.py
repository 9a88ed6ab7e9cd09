"""TT math, DSE, packing, quantization and the H100 hardware model."""
