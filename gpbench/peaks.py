"""The card's peaks, against which every roofline share and ``mfu`` is
read (NVIDIA's data sheet for the H100 SXM part, dense rates, 700 W).

Matrix products are priced at a third of the dense TF32 rate: three TF32
passes (3xTF32) is the card's fastest product that keeps float32 accuracy.
Every other floating-point operation is priced at the float32 rate outside
the tensor cores. These prices are the same whatever route a kernel takes,
so a kernel that moves a product onto the tensor cores raises its share and
cannot push it past 100 %.
"""

PRODUCT_FLOPS = 495e12 / 3    # 3xTF32 products: 165 TFLOP/s
OTHER_FLOPS = 67e12           # float32 FMA pipes
BYTES_PER_S = 3.35e12         # HBM3
