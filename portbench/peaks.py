"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W): the denominators of every roofline and MFU share."""

HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {
    "float32": 67e12,       # CUDA cores
    "tf32": 495e12,         # tensor cores, 10-bit mantissa
    "bfloat16": 989e12,
    # the fastest float32-accurate matrix product: three TF32 products per
    # product (3xTF32), faster than the CUDA cores
    "float32_accurate": 495e12 / 3,
}


def matmul_peak(dtype: str) -> float:
    """The rate a product in ``dtype`` at that dtype's accuracy cannot
    pass."""
    return (FLOP_PER_S["float32_accurate"] if dtype == "float32"
            else FLOP_PER_S[dtype])
