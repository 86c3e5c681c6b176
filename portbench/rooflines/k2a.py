"""K2a (``csrc/knn2.cu``): exact binary 2-NN by Hamming distance, with the
cross-check.

The work of the algorithm, not the instructions a kernel issues: the
Hamming distance of two b-bit descriptors is a product of b bits, counted
as 2 b operations a pair, set against the fastest route this card has for
it, the b1 tensor cores (``mma.sync.m16n8k256 .b1 .and.popc``, one
``BMMA`` of 2 x 16 x 8 x 256 = 65,536 operations). No peak is published
for them: ``chip_probes/mma_probe.py`` reads 0.59-0.61 ``BMMA`` per clock
per SM on an H100; at its top, on 132 SMs at the 1.98 GHz maximum boost
clock, 1.0448e16 op/s. The INT8 tensor cores' published 1,979 TOP/s is
5.3x slower for the same product (its +-1-byte form), so a count at that
peak is no bound: a kernel on the b1 route can pass it. The selection of
the two nearest (the compares and the key of each pair) is left out on
purpose: no least instruction count per pair holds across designs
(packed 16-bit lanes, three-input minima), so the count bounds every
design and stays tight where the product binds. A card that clocks lower
only reads a lower share.

Each input byte (both descriptor sets and the columns' valid flags) is
read once and each output byte (distance, second distance, index per row)
written once, at 3.35 TB/s (HBM3, NVIDIA H100 SXM5 80 GB data sheet). A
search's bound is the larger of its two times.
"""

# 0.61 BMMA / clk / SM x 65,536 ops x 132 SMs x 1.98e9 Hz
B1_TENSOR_OPS_S = 0.61 * 65536 * 132 * 1.98e9
HBM_BYTES_S = 3.35e12


def ops(n1: int, n2: int, bits: int) -> float:
    return 2.0 * n1 * n2 * bits


def bytes_moved(n1: int, n2: int, bits: int) -> float:
    return (n1 + n2) * bits / 8 + n2 + 12.0 * n1


def bound_s(n1: int, n2: int, bits: int) -> float:
    return max(ops(n1, n2, bits) / B1_TENSOR_OPS_S,
               bytes_moved(n1, n2, bits) / HBM_BYTES_S)


def least_s(config: dict) -> float:
    """A query's least time against the map configuration `config`: its
    N1 = ``slots`` rows searched against every map row (``frames`` x
    ``slots``), and, with ``cross_check``, the reverse search of at most
    N1 rows, those the forward matches name."""
    n1 = config["slots"]
    bits = 32 * config["words"]
    least = bound_s(n1, config["frames"] * n1, bits)
    if config["cross_check"]:
        least += bound_s(n1, n1, bits)
    return least
