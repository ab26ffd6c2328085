"""Operations and bytes of the port's kernels and of a whole model step,
computed from shapes: one file a kernel. Peaks are NVIDIA's data sheet
figures for one H100 SXM (dense, no sparsity, at 700 W)."""
PEAK_BF16 = 989e12        # FLOP/s
PEAK_INT8 = 1979e12       # OP/s
HBM = 3.35e12             # bytes/s
