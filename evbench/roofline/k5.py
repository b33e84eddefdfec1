"""K5, `chunk_sums_kernel` and `cross_chunk_kernel` (`ops/cuda_update.py`,
one call): table[r] -= the sum of the sorted entries of row r, over a group
of float32 tables.  The sort before it is a kernel of its own."""

from evbench.roofline.peaks import bound_s

KERNELS = ("chunk_sums_kernel", "cross_chunk_kernel")


def cost(K: int, U: int, D: int):
    """(bytes, flops) of one call: K int32 row ids and K x D float32 values
    read once, each of the U distinct rows read and written once; one add
    a value and one a row's column."""
    return 4 * K + 4 * D * K + 2 * 4 * D * U, D * (K + U)


def bound(K: int, U: int, D: int) -> float:
    return bound_s(*cost(K, U, D))
