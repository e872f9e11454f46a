"""The yardstick's peaks: the H100's, against which the per-layer
readers set the operations and bytes that a cell's model module
(``perfbench/reference/``, ``model.py`` by default) counts from shapes.

The peaks are NVIDIA's data sheet for the H100 SXM (dense rates), the
figures ``repro_torch.core.analytical.H100`` uses: 989 TFLOP/s in bf16
and 3.35 TB/s of HBM bandwidth, at the full 700 W.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
