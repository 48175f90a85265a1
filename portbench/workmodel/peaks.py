"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet, dense
rates), which assume the card's full power limit of 700 W; a run prints the
card's own limit beside its numbers.

Float32 is counted against the FP32 rate outside the tensor cores: the
port computes float32 at full precision (no TF32). Float64 is counted
against the FP64 tensor cores (DMMA), which the port's float64 Gram
instances use."""

PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
HBM_BYTES_PER_S = 3.35e12
