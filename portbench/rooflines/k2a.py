"""K2a (``csrc/knn2.cu``): exact binary 2-NN by Hamming distance.

The work of the algorithm, not the instructions the kernel issues: the
Hamming distance of two b-bit descriptors equals a +-1 dot product of b
elements, so each (row, column) pair counts 2 b operations, set against
the card's dense INT8 tensor-core peak. Each input byte (both descriptor
sets and the columns' valid flags) is read once and each output byte
(distance, second distance, index per row) written once. The bound is the
larger of the two times.

Peaks: NVIDIA H100 SXM5 80 GB data sheet, dense (no sparsity), at the
700 W power limit: 1,979 TOP/s INT8 tensor core, 3.35 TB/s HBM3.
"""

import re

INT8_TENSOR_OPS_S = 1.979e15
HBM_BYTES_S = 3.35e12
# the kernel's device names (the fixed widths and the runtime width); not
# K2b's knn2_l2_kernel
KERNEL = re.compile(r"\bknn2(?:_wide)?_kernel\b")


def ops(n1: int, n2: int, bits: int) -> float:
    return 2.0 * n1 * n2 * bits


def bytes_moved(n1: int, n2: int, bits: int) -> float:
    return (n1 + n2) * bits / 8 + n2 + 12.0 * n1


def bound_s(n1: int, n2: int, bits: int) -> float:
    return max(ops(n1, n2, bits) / INT8_TENSOR_OPS_S,
               bytes_moved(n1, n2, bits) / HBM_BYTES_S)
