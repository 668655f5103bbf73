"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit). The card's power limit is recorded beside every run."""

# the highest rate at which matrix work on float32 inputs can run (TF32
# tensor cores); K2's 3xTF32 split does three such products per product,
# so it can reach a third of this at most
TF32_FLOPS = 495e12
# float32 outside the tensor cores
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
